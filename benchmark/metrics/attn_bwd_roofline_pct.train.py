"""attn_bwd_roofline_pct.train: the area-attention backward's two kernels
(key rows, query rows) against the bound of one backward, in the traced
training window."""

from benchmark.lib.readers import attention_roofline


def read(ctx):
    return attention_roofline(ctx, True, "bwd_key_rows", "bwd_query_rows")
