"""Operations and bytes of the program's hand-written kernels, from the
shapes of a call: the work the call needs, not what an implementation does.

Copied from the arithmetic that ``chip_smoke.py`` (the port's kernel smoke
test) uses beside its kernel timings:
  * K2, the fused W8A8 ConvBN (``cvm_tpu_torch::fused_qconv``): operations
    2 * B * H * W * k * k * Cin * Cout; bytes the input, the int8 weights,
    the float32 scale and bias and the output, each once.
  * K1, the Gaussian heatmap splat: bytes the map written once and the
    objects read once.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W).
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# The card names whose peaks these are, most specific first; None: unknown.
CARD_PEAKS = (("H100 NVL", None), ("H100 PCIe", None), ("H100", PEAK_BF16_FLOPS))


def bf16_peak(card: str):
    """Dense bf16 FLOP/s of ``card`` (``torch.cuda.get_device_name()``), or
    None for a card whose peak this table does not hold."""
    for sub, peak in CARD_PEAKS:
        if sub in card:
            return peak
    return None


def k2_bound_s(B: int, H: int, W: int, cin: int, cout: int, k: int,
               x_bytes: int, out_bytes: int) -> float:
    """The least time one K2 call can take: max(ops / int8 peak, bytes /
    HBM bandwidth), in seconds."""
    ops = 2.0 * B * H * W * k * k * cin * cout
    nbytes = B * H * W * (cin * x_bytes + cout * out_bytes) + k * k * cin * cout + 8 * cout
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)


def k1_bound_s(B: int, Hs: int, Ws: int, C: int, K: int) -> float:
    """The least time one K1 call can take: its float32 map written once and
    its objects (iy, ix, sigma, radius, class: 4 bytes each; valid: 1)
    read once, at the HBM bandwidth."""
    return (B * Hs * Ws * C * 4 + B * K * 21) / PEAK_BYTES
