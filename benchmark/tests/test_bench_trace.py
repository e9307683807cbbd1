"""The trace reader on hand-made profiler events."""

import pytest

from benchmark.lib import trace as T


class Ev:
    def __init__(self, name, dev, s, e):
        self._n, self._d, self._s, self._e = name, dev, s, e

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int((self._e - self._s) * 1e9)


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


def test_busy_kernels_and_gaps():
    ev = [Ev("bench.window", False, 1.0, 5.0), Ev("bench.run", False, 1.0, 2.0),
          Ev("bench.wait", False, 3.0, 4.0), Ev("bench.run", True, 1.0, 5.0),  # span image
          Ev("void attention_bf16_kernel<1>(x)", True, 1.5, 2.5),
          Ev("nms_kernel", True, 2.25, 2.75), Ev("Memcpy HtoD", True, 4.5, 4.75),
          Ev("Context Sync", True, 2.75, 4.5), Ev("before", True, 0.5, 1.25)]
    tr = T.Trace(Prof(ev))
    assert tr.window_s == pytest.approx(4.0)
    # [1, 1.25] + [1.5, 2.75] + [4.5, 4.75]
    assert tr.busy_s == pytest.approx(0.25 + 1.25 + 0.25)
    assert tr.kernel("attention_bf16_kernel") == (pytest.approx(1.0), 1)
    assert tr.kernel("nms_kernel", "Memcpy") == (pytest.approx(0.75), 2)
    gaps = dict(tr.idle_gaps())
    assert gaps["host: bench.run"] == pytest.approx(0.25)        # [1.25, 1.5]
    assert gaps["host: bench.wait"] == pytest.approx(1.75)       # [2.75, 4.5]
    assert gaps["host: in no benchmark span"] == pytest.approx(0.25)  # [4.75, 5]
    assert tr.top_ops()[0][0].startswith("void attention_bf16_kernel")
    tr.add_host_spans("submit", [(10.1, 10.4)], window_start_perf=10.0)  # -> [1.1, 1.4]
    assert ("bench.submit", pytest.approx(1.1), pytest.approx(1.4)) in tr.spans
    assert dict(tr.idle_gaps())["host: bench.submit"] == pytest.approx(0.25)
