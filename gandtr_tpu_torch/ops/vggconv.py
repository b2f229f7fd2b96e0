"""VGG16's 64- and 128-channel 3x3 SAME convolutions in bf16 (counterpart of
gandtr_tpu/ops/vggconv_pallas.py), NHWC with HWIO weights.

    out = round_to_out_dtype(relu?(conv3x3(zero_pad1(x), w) + b))

with bf16 operands, float32 accumulation, the bias and ReLU in float32, and
one rounding to `out_dtype`. `conv3x3_same` dispatches by the tensor's
device: a CPU tensor takes `conv3x3_same_plain`, a CUDA tensor launches K2
(kernels/vggconv.py, csrc/vggconv.cu) or raises.

`Conv3x3Same` is the differentiable op (the JAX package's custom VJP,
vggconv_pallas.py:200-249): the forward is the kernel; the backward masks
the cotangent by the kernel's own output when ReLU is fused (a float32
recomputation would disagree on near-zero pre-activations), dx is the conv
with flipped, in/out-swapped weights, dw the batch/feature-transposed conv,
db the sum. Those are PyTorch convolutions, as the JAX backward is XLA
convolutions, in the JAX backward's types: dx in the cotangent's dtype, dw
in the input's (bf16 on the fine-tune path). A bf16 convolution takes
float32 sums of exact products (cuDNN's and oneDNN's compute type for bf16)
and rounds once at its output, so dw's sum over every pixel of the batch
stays float32 until that one rounding; db sums in float32.
"""
import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
CHANNELS = (64, 128)


def conv3x3_same_plain(x, w, b=None, relu=False, out_dtype=None):
    """The plain PyTorch version of K2. x: (N, H, W, C); w: (3, 3, C, C)
    HWIO; b: (C,) or None. The conv is float32 on the bf16 values, so every
    product is exact and only the summation order differs from the kernel."""
    out_dtype = out_dtype or x.dtype
    xf = x.to(BF16).float().permute(0, 3, 1, 2)
    wf = w.to(BF16).float().permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, padding=1).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def eligible(x_shape, dtype, cin, cout, kernel_size, stride, dilation,
             padding):
    """Whether a conv takes K2: vggconv_pallas.py:252-266 without the TPU's
    enable flag, tiling plan and VMEM budget, and only for bf16 input (the
    float32 path stays cuDNN float32)."""
    return (dtype == BF16 and len(x_shape) == 4 and cin == cout
            and cin in CHANNELS and kernel_size == 3 and stride == 1
            and dilation == 1 and padding == 1
            and x_shape[1] >= 1 and x_shape[2] >= 1)


def conv3x3_same(x, w, b=None, relu=False, out_dtype=None):
    """Dispatch by device. x: (N, H, W, C) NHWC; w: (3, 3, C, C) HWIO."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, w, b, relu, out_dtype)
    from gandtr_tpu_torch.kernels.vggconv import conv3x3_same_cuda
    C = x.shape[-1]
    bias = (torch.zeros(C, dtype=torch.float32, device=x.device) if b is None
            else b.detach().float().contiguous())
    return conv3x3_same_cuda(x.detach().to(BF16).contiguous(),
                             w.detach().to(BF16).contiguous().view(9 * C, C),
                             bias, relu, out_dtype)


class Conv3x3Same(torch.autograd.Function):
    """K2 forward, PyTorch-convolution backward. apply(x, w, b, relu,
    out_dtype) with x (N, H, W, C), w (3, 3, C, C) HWIO, b (C,) or None."""

    @staticmethod
    def forward(ctx, x, w, b, relu, out_dtype):
        y = conv3x3_same(x, w, b, relu, out_dtype)
        ctx.save_for_backward(x, w, y if relu else None)
        ctx.relu = relu
        ctx.b_dtype = None if b is None else b.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        if ctx.relu:
            g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                                  device=g.device))
        gc = g.permute(0, 3, 1, 2)               # NHWC memory as NCHW
        xc = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xc.shape, w_oihw.to(g.dtype), gc,
                                            padding=1)
            dx = dx.permute(0, 2, 3, 1).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xc, w_oihw.shape,
                                             gc.to(x.dtype), padding=1)
            dw = dw.permute(2, 3, 1, 0).to(w.dtype)
        if ctx.b_dtype is not None and ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 2)).to(ctx.b_dtype)
        return dx, dw, db, None, None
