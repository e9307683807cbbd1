"""attn_bwd_roofline_pct.train_v10: the area-attention backward's (36, 72)
build (its two kernels, ``bwd_k36_query_rows`` and ``bwd_k36_key_rows``)
against ``arith.attention_bwd_cost`` at 36 / 72 for one backward, in the
traced training window; None where the trace holds no such launch."""

from benchmark.lib.readers_v10 import k36_roofline


def read(ctx):
    return k36_roofline(ctx, True, "bwd_k36_query_rows", "bwd_k36_key_rows")
