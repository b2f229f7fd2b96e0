"""Colorspace conversions on tensors, matching OpenCV's float32 LAB path.

Counterpart of gandtr_tpu/ops/colorspace.py (lab branches): the same
constants and the same piecewise functions, on (..., 3) channel-last float32
tensors. Torch has no `cbrt`; `t.pow(1/3)` stands in for it on the
`t > 0.008856` branch, where `t` is positive.
"""
import torch

# D65 white point used by OpenCV
_WHITE = (0.950456, 1.0, 1.088754)

# linear RGB -> XYZ (OpenCV/sRGB primaries)
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)

_LAB_SHIFT = (0.0, 128.0, 128.0)
_LAB_SCALE = (100.0, 255.0, 255.0)


def _srgb_inv_gamma(x):
    """sRGB EOTF: companded -> linear."""
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _srgb_gamma(x):
    """sRGB OETF: linear -> companded."""
    x = x.clamp(min=0.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * x ** (1.0 / 2.4) - 0.055)


def _rgb_to_xyz(rgb):
    rgb = _srgb_inv_gamma(rgb)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    x = _RGB2XYZ[0][0] * r + _RGB2XYZ[0][1] * g + _RGB2XYZ[0][2] * b
    y = _RGB2XYZ[1][0] * r + _RGB2XYZ[1][1] * g + _RGB2XYZ[1][2] * b
    z = _RGB2XYZ[2][0] * r + _RGB2XYZ[2][1] * g + _RGB2XYZ[2][2] * b
    return x, y, z


def _lab_f(t):
    # the cube-root branch only ever sees t > 0.008856; clamp keeps pow's
    # NaN for negative t out of the discarded branch
    return torch.where(t > 0.008856, t.clamp(min=0.008856) ** (1.0 / 3.0),
                       7.787 * t + 16.0 / 116.0)


def _lab_f_inv(ft):
    return torch.where(ft > 0.2068966, ft ** 3, (ft - 16.0 / 116.0) / 7.787)


def rgb_to_lab(rgb):
    """float RGB[0,1] -> Lab (L in [0,100], a,b in [-127,127])."""
    x, y, z = _rgb_to_xyz(rgb)
    fx = _lab_f(x / _WHITE[0])
    fy = _lab_f(y / _WHITE[1])
    fz = _lab_f(z / _WHITE[2])
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L, a, b], dim=-1)


def lab_to_rgb(lab):
    """Inverse of rgb_to_lab; cv2.COLOR_LAB2RGB float path."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    x = _lab_f_inv(fx) * _WHITE[0]
    y = _lab_f_inv(fy) * _WHITE[1]
    z = _lab_f_inv(fz) * _WHITE[2]
    r = 3.240479 * x - 1.537150 * y - 0.498535 * z
    g = -0.969256 * x + 1.875992 * y + 0.041556 * z
    bl = 0.055648 * x - 0.204043 * y + 1.057311 * z
    return _srgb_gamma(torch.stack([r, g, bl], dim=-1))


def _chan(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def rgb2normspace(img, colorspace):
    """RGB[0,1] -> normalized colorspace with every channel in [0, 1]."""
    if colorspace.lower() == "lab":
        return (rgb_to_lab(img) + _chan(_LAB_SHIFT, img)) / _chan(_LAB_SCALE, img)
    raise NotImplementedError("Colorspace %s is not ported" % colorspace)


def normspace2rgb(img, colorspace):
    """Inverse of rgb2normspace. cv2 saturates the LAB2RGB float output to
    [0, 1], and so does this."""
    if colorspace.lower() == "lab":
        lab = img * _chan(_LAB_SCALE, img) - _chan(_LAB_SHIFT, img)
        return lab_to_rgb(lab).clamp(0.0, 1.0)
    raise NotImplementedError("Colorspace %s is not ported" % colorspace)
