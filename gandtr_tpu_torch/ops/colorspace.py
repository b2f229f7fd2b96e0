"""Colorspace conversions on tensors, matching OpenCV's float32 paths.

Counterpart of gandtr_tpu/ops/colorspace.py: the same constants, the same
piecewise functions and the same float32 operation order (hue included,
at achromatic pixels and at the 360 wrap), on (..., 3) channel-last
float32 tensors. Torch has no `cbrt`; `t.pow(1/3)` stands in for it on
the `t > 0.008856` branches, where `t` is positive.

`rgb2normspace` / `normspace2rgb` map RGB in [0, 1] to the reference's
normalized spaces, every channel in [0, 1]: lab, luv, lsh (HLS reordered
to lightness, saturation, hue), hsv, yxz (XYZ with Y first), gray, bgr and
rgb; an `s` prefix (`slab`, ...) applies `** 2.2` before the conversion
and `** (1 / 2.2)` after the way back. lab and luv saturate the way back
to [0, 1] as cv2 does; hls, hsv and xyz do not. gray and bgr have no way
back (the JAX package raises there too).
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
_LUV_SHIFT = (0.0, 134.0, 140.0)
_LUV_SCALE = (100.0, 354.0, 262.0)
_HUE_SCALE = (360.0, 1.0, 1.0)


def _srgb_inv_gamma(x):
    """sRGB EOTF: companded -> linear."""
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _srgb_gamma(x):
    """sRGB OETF: linear -> companded."""
    x = x.clamp(min=0.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * x ** (1.0 / 2.4) - 0.055)


def _rgb_to_xyz(rgb, gamma=True):
    if gamma:
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
    return _srgb_gamma(_xyz_to_rgb(x, y, z))


def _xyz_to_rgb(x, y, z):
    r = 3.240479 * x - 1.537150 * y - 0.498535 * z
    g = -0.969256 * x + 1.875992 * y + 0.041556 * z
    b = 0.055648 * x - 0.204043 * y + 1.057311 * z
    return torch.stack([r, g, b], dim=-1)


def _luv_white():
    xw, yw, zw = _WHITE
    dn = xw + 15.0 * yw + 3.0 * zw
    return 4.0 * xw / dn, 9.0 * yw / dn


def rgb_to_luv(rgb):
    """cv2.COLOR_RGB2LUV float path (with sRGB gamma)."""
    x, y, z = _rgb_to_xyz(rgb)
    L = torch.where(y > 0.008856,
                    116.0 * y.clamp(min=0.008856) ** (1.0 / 3.0) - 16.0,
                    903.3 * y)
    d = x + 15.0 * y + 3.0 * z
    d = torch.where(d == 0, torch.full_like(d, 1e-20), d)
    u_ = 4.0 * x / d
    v_ = 9.0 * y / d
    un, vn = _luv_white()
    u = 13.0 * L * (u_ - un)
    v = 13.0 * L * (v_ - vn)
    return torch.stack([L, u, v], dim=-1)


def luv_to_rgb(luv):
    """Inverse of rgb_to_luv (before cv2's saturation)."""
    L, u, v = luv[..., 0], luv[..., 1], luv[..., 2]
    un, vn = _luv_white()
    Ls = torch.where(L == 0, torch.full_like(L, 1e-20), L)
    u_ = u / (13.0 * Ls) + un
    v_ = v / (13.0 * Ls) + vn
    y = torch.where(L > 8.0, ((L + 16.0) / 116.0) ** 3, L / 903.3)
    v_ = torch.where(v_ == 0, torch.full_like(v_, 1e-20), v_)
    x = y * 9.0 * u_ / (4.0 * v_)
    z = y * (12.0 - 3.0 * u_ - 20.0 * v_) / (4.0 * v_)
    return _srgb_gamma(_xyz_to_rgb(x, y, z))


def _hue(mx, r, g, b, diff):
    """Hue in [0, 360) of the JAX package's float32 formula; 0 where the
    pixel is achromatic (max == min)."""
    safe = torch.where(diff == 0, torch.ones_like(diff), diff)
    h = torch.where(mx == r, 60.0 * (g - b) / safe,
                    torch.where(mx == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff == 0, torch.zeros_like(h), h)
    return torch.where(h < 0, h + 360.0, h)


def rgb_to_hsv(rgb):
    """cv2.COLOR_RGB2HSV float path: H in [0, 360), S, V in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    s = torch.where(v == 0, torch.zeros_like(v),
                    diff / torch.where(v == 0, torch.ones_like(v), v))
    return torch.stack([_hue(v, r, g, b, diff), s, v], dim=-1)


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = (h / 60.0) % 6.0
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32)

    def select(*picks):
        out = picks[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, picks[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def rgb_to_hls(rgb):
    """cv2.COLOR_RGB2HLS float path: H in [0, 360), L, S in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    l = (mx + mn) / 2.0
    diff = mx - mn
    denom = torch.where(l < 0.5, mx + mn, 2.0 - mx - mn)
    s = torch.where(diff == 0, torch.zeros_like(diff),
                    diff / torch.where(denom == 0, torch.ones_like(denom),
                                       denom))
    return torch.stack([_hue(mx, r, g, b, diff), l, s], dim=-1)


def hls_to_rgb(hls):
    h, l, s = hls[..., 0], hls[..., 1], hls[..., 2]
    q = torch.where(l < 0.5, l * (1.0 + s), l + s - l * s)
    p = 2.0 * l - q

    def hue2rgb(t):
        t = t % 360.0
        return torch.where(
            t < 60.0, p + (q - p) * t / 60.0,
            torch.where(t < 180.0, q,
                        torch.where(t < 240.0,
                                    p + (q - p) * (240.0 - t) / 60.0, p)))

    return torch.stack([hue2rgb(h + 120.0), hue2rgb(h), hue2rgb(h - 120.0)],
                       dim=-1)


def rgb_to_xyz(rgb):
    """cv2.COLOR_RGB2XYZ float path: no gamma in OpenCV."""
    return torch.stack(_rgb_to_xyz(rgb, gamma=False), dim=-1)


def xyz_to_rgb(xyz):
    return _xyz_to_rgb(xyz[..., 0], xyz[..., 1], xyz[..., 2])


def rgb_to_gray(rgb):
    """cv2.COLOR_RGB2GRAY: 0.299 R + 0.587 G + 0.114 B, as (..., 1)."""
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
            + 0.114 * rgb[..., 2])[..., None]


def _chan(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _standard(colorspace):
    """(the space without an `s` prefix, whether it had one)."""
    colorspace = colorspace.lower()
    if len(colorspace) == 4 and colorspace[0] == "s":
        return colorspace[1:], True
    return colorspace, False


def _reorder(img, order):
    return torch.stack([img[..., i] for i in order], dim=-1)


def rgb2normspace(img, colorspace):
    """RGB[0,1] -> normalized colorspace with every channel in [0, 1]."""
    colorspace, standard = _standard(colorspace)
    if standard:
        img = img ** 2.2
    if colorspace == "lab":
        return (rgb_to_lab(img) + _chan(_LAB_SHIFT, img)) / _chan(_LAB_SCALE,
                                                                  img)
    if colorspace == "luv":
        return (rgb_to_luv(img) + _chan(_LUV_SHIFT, img)) / _chan(_LUV_SCALE,
                                                                  img)
    if colorspace == "lsh":
        return _reorder(rgb_to_hls(img) / _chan(_HUE_SCALE, img), (1, 2, 0))
    if colorspace == "hsv":
        return rgb_to_hsv(img) / _chan(_HUE_SCALE, img)
    if colorspace == "yxz":
        return _reorder(rgb_to_xyz(img), (1, 0, 2))
    if colorspace == "gray":
        return rgb_to_gray(img)
    if colorspace == "bgr":
        return img.flip(-1)
    if colorspace == "rgb":
        return img
    raise NotImplementedError("Colorspace %s is not supported" % colorspace)


def normspace2rgb(img, colorspace):
    """Inverse of rgb2normspace. cv2 saturates the LAB2RGB and LUV2RGB
    float output to [0, 1], and so does this; the other spaces are not
    clipped. gray and bgr raise, as in the JAX package."""
    colorspace, standard = _standard(colorspace)
    if colorspace == "lab":
        lab = img * _chan(_LAB_SCALE, img) - _chan(_LAB_SHIFT, img)
        out = lab_to_rgb(lab).clamp(0.0, 1.0)
    elif colorspace == "luv":
        luv = img * _chan(_LUV_SCALE, img) - _chan(_LUV_SHIFT, img)
        out = luv_to_rgb(luv).clamp(0.0, 1.0)
    elif colorspace == "lsh":
        out = hls_to_rgb(_reorder(img, (2, 0, 1)) * _chan(_HUE_SCALE, img))
    elif colorspace == "hsv":
        out = hsv_to_rgb(img * _chan(_HUE_SCALE, img))
    elif colorspace == "yxz":
        out = xyz_to_rgb(_reorder(img, (1, 0, 2)))
    elif colorspace == "rgb":
        out = img
    else:
        raise NotImplementedError("Colorspace %s is not supported"
                                  % colorspace)
    if standard:
        return out ** (1.0 / 2.2)
    return out
