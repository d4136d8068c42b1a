"""Each metric reader on a canned record, and the trace reduction on
canned kineto events."""
import pytest
import smoke  # noqa: F401

import cost
import harness
import profiling

WINDOW = {"seconds": 2.0, "tokens": 100, "ttft_ms": list(range(1, 21)),
          "itl_ms": [10.0] * 19 + [50.0], "admitted": 20, "rejected": 0,
          "prompt_tokens": 300, "prefills": 15,
          "admit_ms": [(30.0, 2), (90.0, 18)], "step_ms": [20.0, 40.0],
          "finished": 5}
CALL = {"shapes": [(4, 3, 16), (4, 16, 8)], "dtype_bytes": 2}
M = {"n_layers": 1, "d_model": 4, "n_heads": 1, "n_kv_heads": 1,
     "head_dim": 4, "d_ff": 8, "vocab_size": 10}
REC = {"setup_s": 12.5, "window": WINDOW, "model": M,
       "trace": {"window_s": 2.0, "busy_s": 0.5,
                 "kernels": {"pb.step": 30, "pb.admit": 7},
                 "spans": {"pb.step": 3, "pb.admit": 1},
                 "ops": {"gmm": [4 * cost.moe_gmm(CALL)]}},
       "calls": {"gmm": [CALL]}}
EXPECT = {
    "setup_s": 12.5,
    "tokens_per_s": 50.0,
    "ttft_p95_ms": 19.05,
    "itl_p95_ms": 12.0,
    "prefill_passes_per_req": 0.75,
    "prefill_ms_per_req": 6.0,
    "decode_step_ms": 30.0,
    "launches_per_decode_step": 10.0,
    "moe_gmm_roofline": 25.0,
    "idle_share.serve": 75.0,
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_on_a_canned_record(name):
    assert harness.reader(name)(REC) == pytest.approx(EXPECT[name])


def test_mfu_serve_by_hand():
    from flops import param_count
    n = param_count(M, active=True)
    assert harness.reader("mfu.serve")(REC) == pytest.approx(
        100 * 2 * n * 400 / (2.0 * 989e12))


@pytest.mark.parametrize("name", sorted(set(EXPECT) - {"setup_s"}))
def test_reader_finds_nothing_to_read(name):
    empty = {"setup_s": 1.0, "window": {"seconds": 1.0, "ttft_ms": [],
                                        "itl_ms": [], "admitted": 0,
                                        "step_ms": []},
             "trace": None, "calls": {}}
    if name == "tokens_per_s":
        return   # a window always has its token count
    assert harness.reader(name)(empty) is None


def test_every_metric_has_a_reader():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


class _Dev:
    def __init__(self, s):
        self.s = s

    def __str__(self):
        return "DeviceType." + self.s


class _Ev:
    """A kineto event as torch 2.11 gives it (no ``activity_type``)."""

    def __init__(self, name, dev, start, dur, corr=0):
        self.n, self.d, self.s, self.t, self.c = name, dev, start, dur, corr

    def name(self):
        return self.n

    def device_type(self):
        return _Dev(self.d)

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.t

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return 0


def test_reduce_events():
    ev = [_Ev("pb.traced", "CPU", 0, 1000), _Ev("pb.step", "CPU", 100, 500),
          _Ev("pb.op.gmm", "CPU", 150, 100),
          _Ev("cudaLaunchKernel", "CPU", 160, 5, 7),
          _Ev("aten::add", "CPU", 120, 5, 7),        # an op id, not CUPTI's
          _Ev("k1", "CUDA", 300, 50, 7),
          _Ev("cudaLaunchKernel", "CPU", 400, 5, 8),
          _Ev("k2", "CUDA", 420, 30, 8),
          _Ev("Memcpy DtoH", "CUDA", 460, 10, 9),
          _Ev("pb.step", "CUDA", 100, 500)]          # a device annotation
    t = profiling.reduce_events(ev)
    assert t["window_s"] == pytest.approx(1e-6)
    assert t["busy_s"] == pytest.approx(90e-9)      # 50 + 30 + 10 ns
    assert t["kernels"] == {"pb.step": 2}
    assert t["ops"] == {"gmm": [pytest.approx(50e-9)]}
    assert [n for n, _ in t["device_ops"]] == ["k1", "k2", "Memcpy DtoH"]
    gaps = dict(t["idle_gaps"])
    # 0-300 and 470-1000 around the host's annotation-free time, 350-420
    # while the host was inside pb.step
    assert gaps["pb.step"] == pytest.approx(80e-9)
    assert sum(gaps.values()) == pytest.approx(910e-9)


def test_reduce_events_without_device_activity():
    t = profiling.reduce_events([_Ev("pb.traced", "CPU", 0, 10)])
    assert "busy_s" not in t and t["kinds"] == {"user_annotation": 1}
