"""attn_fwd_roofline_pct.train_v10: the area-attention forward kernel's
(key_dim, head_dim) = (36, 72) build (``attention_k36_bf16``, yolov10m's
PSA) against ``arith.attention_fwd_cost`` at 36 / 72, in the traced
training window; None where the trace holds no such launch."""

from benchmark.lib.readers_v10 import k36_roofline


def read(ctx):
    return k36_roofline(ctx, False, "attention_k36_bf16")
