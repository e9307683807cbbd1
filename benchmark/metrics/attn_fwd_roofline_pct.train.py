"""attn_fwd_roofline_pct.train: the area-attention forward kernel's share of
its roofline in the traced training window (bytes or bf16 operations,
whichever bounds; the benchmark's own count)."""

from benchmark.lib.readers import attention_roofline


def read(ctx):
    return attention_roofline(ctx, False, "attention_bf16_kernel")
