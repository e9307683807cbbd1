"""Host-side utility kit: formatting, filesystem browsing, kv parsing, xlsx IO."""

from .formats import (  # noqa: F401
    format_bytes,
    format_duration,
    format_int,
    format_ratio,
    safe_dataframe,
)
from .kv import parse_kv_lines  # noqa: F401
from .naming import safe_filename  # noqa: F401
