"""Port parity: the profile session and the roofline ledger
(`mmlspark_tpu_torch.telemetry.profiler`) against the reference's
`mmlspark_tpu.telemetry.profiler`, JAX on the CPU.

- `RooflineLedger.rows()` and `export()`: the same notes, device tables,
  costs and explicit peaks give the same rows in both packages, to 1e-12
  relative;
- `resolve_peaks`: the same precedence (explicit, env, chip table) under
  the same env;
- `parse_trace` of a synthetic Chrome trace built here (kernels inside
  and outside annotation ranges, two threads, a helper thread, a kernel
  with no launch event): the per-region totals are stated exactly;
- `ProfileSession`'s rate limit, retention and rollback of a failing
  capture give the reference's counters;
- a real capture of a small `device="cpu"` GBDT fit: an empty device
  table (no device events on the CPU, as the reference's CPU backend
  gives none) and host rows for the three GBDT regions.
"""
import json
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.reliability import metrics as ref_metrics
from mmlspark_tpu.telemetry import profiler as ref_prof
from mmlspark_tpu_torch.reliability import metrics as port_metrics
from mmlspark_tpu_torch.telemetry import names, profiler

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_RTOL = 1e-12


class _Log:
    """A compile log stand-in with no records: both ledgers join only the
    costs set here."""

    def records(self):
        return []


def _feed(ledger, seed):
    rng = np.random.default_rng(seed)
    for region in ("gbdt.hist", "gbdt.split", "gbdt.route", "train.step"):
        for _ in range(int(rng.integers(1, 4))):
            ledger.note_region(region, float(rng.uniform(1e-4, 5e-2)))
    ledger.note_region("serving.plan.run", 0.0125, occurrences=3,
                       source="bench-phase")
    ledger.set_cost("gbdt.hist", bytes_accessed=float(rng.integers(1e6, 1e9)))
    ledger.set_cost("gbdt.split", flops=float(rng.integers(1e6, 1e9)),
                    bytes_accessed=float(rng.integers(1e5, 1e8)))
    ledger.set_cost("train.step", flops=float(rng.integers(1e9, 1e12)))
    ledger.set_cost("never.measured", flops=1.0)


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=_RTOL), path
    else:
        assert got == want, path


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("peaks", [
    {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12, "source": "test"},
    {"flops_per_s": 1.0e15, "hbm_bytes_per_s": 2.0e12},
])
def test_roofline_rows_and_export_equal_reference(seed, peaks):
    port = profiler.RooflineLedger(compile_log=_Log(), peaks=peaks)
    ref = ref_prof.RooflineLedger(compile_log=_Log(), peaks=peaks)
    _feed(port, seed)
    _feed(ref, seed)
    _close(port.rows(), ref.rows())
    ops = [{"op": "k1", "region": "gbdt.hist", "occurrences": 5,
            "self_time_us": 812.5},
           {"op": "k2", "region": "gbdt.split", "occurrences": 2,
            "self_time_us": 40.0},
           {"op": "k3", "region": "other", "occurrences": 1,
            "self_time_us": 9.0}]
    port.ingest_ops(ops)
    ref.ingest_ops(ops)
    got, want = port.rows(), ref.rows()
    assert got["gbdt.hist"]["source"] == "device"
    _close(got, want)
    gx, wx = port.export(), ref.export()
    for key in ("peaks", "regions", "ops"):
        _close(gx[key], wx[key], key)


def test_publish_sets_the_reference_gauges():
    peaks = {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
    port = profiler.RooflineLedger(compile_log=_Log(), peaks=peaks)
    ref = ref_prof.RooflineLedger(compile_log=_Log(), peaks=peaks)
    _feed(port, 5)
    _feed(ref, 5)
    preg, rreg = port_metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    port.publish(registry=preg)
    ref.publish(registry=rreg)
    got = preg.export_state()["gauges"]
    want = rreg.export_state()["gauges"]
    assert got == pytest.approx(want, rel=_RTOL)
    assert names.op_hbm_util("gbdt.hist") in got


@pytest.mark.parametrize("explicit, env", [
    (None, {}),
    (None, {"MMLSPARK_TPU_PEAK_TFLOPS": "989",
            "MMLSPARK_TPU_PEAK_HBM_GBPS": "3350"}),
    (None, {"MMLSPARK_TPU_PEAK_HBM_GBPS": "3350"}),
    ({"flops_per_s": 5e14}, {"MMLSPARK_TPU_PEAK_HBM_GBPS": "2000"}),
    ({"flops_per_s": 5e14, "hbm_bytes_per_s": 1e12},
     {"MMLSPARK_TPU_PEAK_TFLOPS": "989"}),
    (None, {"MMLSPARK_TPU_PEAK_TFLOPS": "bad",
            "MMLSPARK_TPU_PEAK_HBM_GBPS": "-1"}),
])
def test_resolve_peaks_precedence_equals_reference(explicit, env,
                                                  monkeypatch):
    for k in ("MMLSPARK_TPU_PEAK_TFLOPS", "MMLSPARK_TPU_PEAK_HBM_GBPS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert profiler.resolve_peaks(explicit) == ref_prof.resolve_peaks(explicit)


def test_chip_table_holds_the_card_only():
    assert [row[0] for row in profiler.CHIP_PEAKS] == ["H100 80GB HBM3"]
    assert profiler.CHIP_PEAKS[0][1:] == (989.0, 3350.0)
    assert profiler.REGIONS == ref_prof.REGIONS
    assert profiler.PROFILE_DIR_ENV == ref_prof.PROFILE_DIR_ENV
    assert profiler.PROFILE_MS_ENV == ref_prof.PROFILE_MS_ENV
    assert profiler.PEAK_HBM_ENV == ref_prof.PEAK_HBM_ENV
    assert profiler._MAX_OP_RECORDS == ref_prof._MAX_OP_RECORDS


# ------------------------------------------------------------ parse_trace
_BASE_NS = 1_000_000_000_000_000
# the session's clock markers at trace times 100 and 200 us: the host
# clock read 40 us behind and 60 us ahead of the first, 10 us either
# side of the second, so the two clocks agree within 10 us
_CLOCK = {"marks": [[_BASE_NS + 60_000, _BASE_NS + 160_000],
                    [_BASE_NS + 190_000, _BASE_NS + 210_000]]}


def _x(cat, name, pid, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _synthetic_trace():
    """Thread 1 profiled (its ranges in the trace), thread 2 not (its
    ranges only in regions.json), thread 3 a helper launching while
    thread 1 waits inside train.step, thread 4 with its ranges in the
    trace under its native id 44 but its launches under its pthread id;
    pid 0 the card."""
    ev = [_x("user_annotation", profiler._CLOCK_MARK, 9, 1, 100.0, 1.0),
          _x("user_annotation", profiler._CLOCK_MARK, 9, 1, 200.0, 1.0),
          _x("user_annotation", "gbdt.hist", 9, 1, 1000.0, 100.0),
          _x("user_annotation", "gbdt.split", 9, 1, 1100.0, 50.0),
          _x("user_annotation", "train.step", 9, 1, 3000.0, 1000.0),
          _x("user_annotation", "gbdt.route", 9, 44, 6000.0, 100.0),
          _x("user_annotation", "gbdt.hist", 9, 55, 6000.0, 100.0)]
    launches = [  # (correlation, tid, ts)
        (1, 1, 1010.0), (2, 1, 1050.0),     # gbdt.hist
        (3, 1, 1120.0),                     # gbdt.split
        (4, 1, 1200.0),                     # outside every range: other
        (5, 2, 2050.0), (6, 2, 2150.0),     # thread 2: gbdt.route, other
        (7, 3, 3130.0),                     # helper: train.step
        (8, 1, 3100.0),                     # train.step
        (9, 4, 6050.0),                     # thread 4: gbdt.route
        (10, 2, 1050.0)]                    # thread 2 outside its own
                                            # ranges: other, not thread
                                            # 1's gbdt.hist
    for corr, tid, ts in launches:
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", 9, tid, ts, 5.0,
                     correlation=corr))
    kernels = [  # (name, correlation, ts, dur)
        ("hist_tile_kernel", 1, 1020.0, 30.0),
        ("fill_kernel", 2, 1060.0, 2.0),
        ("cumsum_kernel", 3, 1130.0, 4.5),
        ("grad_kernel", 4, 1210.0, 7.25),
        ("route_kernel", 5, 2060.0, 11.0),
        ("route_kernel", 6, 2160.0, 3.0),
        ("flash_bwd_dq_mma", 7, 3140.0, 100.0),
        ("flash_fwd_mma", 8, 3110.0, 60.0),
        ("memcpy_no_launch", None, 3200.0, 8.0),
        ("orphan", None, 5000.0, 1.0),
        ("route_kernel", 9, 6060.0, 2.0),
        ("copy_kernel", 10, 1070.0, 1.0)]
    for name, corr, ts, dur in kernels:
        cat = "gpu_memcpy" if name.startswith("memcpy") else "kernel"
        args = {} if corr is None else {"correlation": corr}
        ev.append(_x(cat, name, 0, 7, ts, dur, **args))
    # the device-side range for the launch-less copy
    ev.append(_x("gpu_user_annotation", "train.step", 0, 7, 3100.0, 600.0))
    intervals = [  # thread 2 (native id 22, trace id 2): gbdt.route
        [22, 2, _BASE_NS + 2_000_000, _BASE_NS + 2_100_000, "gbdt.route"],
        [22, 2, _BASE_NS + 2_300_000, _BASE_NS + 2_400_000, "not.a.region"],
        # thread 4: native 44, pthread id 2^32 - 4 (the trace writes the
        # magnitude of its signed 32 bits, 4)
        [44, (1 << 32) - 4, _BASE_NS + 6_000_000, _BASE_NS + 6_100_000,
         "gbdt.route"]]
    return ({"traceEvents": ev, "baseTimeNanoseconds": _BASE_NS},
            {"clock": _CLOCK, "intervals": intervals})


def test_parse_trace_attributes_kernels_by_region(tmp_path):
    trace, sidecar = _synthetic_trace()
    with open(tmp_path / "host_1.pt.trace.json", "w") as f:
        json.dump(trace, f)
    with open(tmp_path / "regions.json", "w") as f:
        json.dump(sidecar, f)
    records = profiler.parse_trace(str(tmp_path))
    got = {(r["op"], r["region"]): (r["occurrences"], r["self_time_us"])
           for r in records}
    assert got == {
        ("hist_tile_kernel", "gbdt.hist"): (1, 30.0),
        ("fill_kernel", "gbdt.hist"): (1, 2.0),
        ("cumsum_kernel", "gbdt.split"): (1, 4.5),
        ("grad_kernel", "other"): (1, 7.25),
        ("route_kernel", "gbdt.route"): (2, 13.0),
        ("route_kernel", "other"): (1, 3.0),
        ("flash_bwd_dq_mma", "train.step"): (1, 100.0),
        ("flash_fwd_mma", "train.step"): (1, 60.0),
        ("memcpy_no_launch", "train.step"): (1, 8.0),
        ("orphan", "other"): (1, 1.0),
        ("copy_kernel", "other"): (1, 1.0)}
    assert [r["self_time_us"] for r in records] == sorted(
        (r["self_time_us"] for r in records), reverse=True)
    totals = profiler.region_totals(records)
    assert totals == ref_prof.region_totals(records)
    assert totals == {
        "gbdt.hist": {"self_time_us": 32.0, "occurrences": 2},
        "gbdt.split": {"self_time_us": 4.5, "occurrences": 1},
        "gbdt.route": {"self_time_us": 13.0, "occurrences": 2},
        "train.step": {"self_time_us": 168.0, "occurrences": 3},
        "other": {"self_time_us": 12.25, "occurrences": 4}}
    _, summary = profiler._parse(str(tmp_path))
    assert summary["device_events"] == 12
    assert summary["launches_found"] == 10
    assert (summary["by_launch"], summary["by_waiting_thread"],
            summary["by_device_range"]) == (6, 1, 1)
    # the union of the device intervals: the backward kernel overlaps the
    # forward by 30 us and holds the copy's 8 us
    assert summary["busy_us"] == 30 + 2 + 4.5 + 7.25 + 11 + 3 + 100 + 60 \
        + 8 + 1 - 30 - 8 + 2 + 1


def test_clock_offset_is_the_middle_of_what_every_marker_allows():
    # markers at trace times 100 and 200 us (base 0)
    marks = [[50_000, 150_000], [195_000, 201_000]]
    assert profiler._clock_offset_ns(marks, [200.0, 100.0], 0) == 2_000.0
    # markers that disagree: the tightest one's middle
    assert profiler._clock_offset_ns([[0, 10_000], [500_000, 502_000]],
                                     [100.0, 200.0], 0) == -301_000.0
    assert profiler._clock_offset_ns([], [], 5) == 0.0


def test_parse_trace_never_raises(tmp_path):
    assert profiler.parse_trace(str(tmp_path / "missing")) == []
    (tmp_path / "torn.pt.trace.json").write_text("{not json")
    assert profiler.parse_trace(str(tmp_path)) == []
    (tmp_path / "torn.pt.trace.json").write_text(json.dumps(
        {"traceEvents": [{"ph": "X", "cat": "kernel", "name": "k",
                          "ts": "bad"}]}))
    assert profiler.parse_trace(str(tmp_path)) == []


# ---------------------------------------------------------- ProfileSession
def _counters(reg, mod_names):
    c = reg.export_state()["counters"]
    return {k: c.get(k, 0) for k in (
        mod_names.TELEMETRY_PROFILE_CAPTURES,
        mod_names.TELEMETRY_PROFILE_SUPPRESSED)}


def _drive(mod, metrics_mod, tmp):
    """One script through a package's ProfileSession: a capture, one the
    rate limit suppresses, a failing capture after the slot frees, then
    retention over three more captures."""
    reg = metrics_mod.MetricsRegistry()
    s = mod.ProfileSession(profile_dir=str(tmp), min_interval_s=3600.0,
                           max_profiles=2, registry=reg)
    seen = []
    first = s.capture(ms=1, reason="first")
    seen.append(first is not None)
    seen.append(s.capture(ms=1, reason="second") is None)
    s.configure(min_interval_s=0.0)
    with pytest.raises(RuntimeError, match="injected"):
        with s.session(reason="boom"):
            raise RuntimeError("injected")
    seen.append(sorted(os.listdir(tmp)) == [os.path.basename(
        first["path"])])
    for i in range(3):
        assert s.capture(ms=1, reason=f"r{i}") is not None
    kept = sorted(os.listdir(tmp))
    return seen, [k.split("-", 2)[2] for k in kept], reg


def test_session_rate_limit_retention_and_rollback_equal_reference(tmp_path):
    port_seen, port_kept, preg = _drive(profiler, port_metrics,
                                        tmp_path / "port")
    ref_seen, ref_kept, rreg = _drive(ref_prof, ref_metrics,
                                      tmp_path / "ref")
    assert port_seen == ref_seen == [True, True, True]
    assert port_kept == ref_kept == ["0003-r1", "0004-r2"]
    from mmlspark_tpu.telemetry import names as ref_names
    assert _counters(preg, names) == _counters(rreg, ref_names) == {
        names.TELEMETRY_PROFILE_CAPTURES: 4,
        names.TELEMETRY_PROFILE_SUPPRESSED: 1}


def test_session_disabled_and_busy(tmp_path):
    s = profiler.ProfileSession(profile_dir=None)
    assert not s.enabled and s.capture(ms=1) is None
    with pytest.raises(RuntimeError, match="disabled"):
        with s.session(reason="x"):
            pass
    reg = port_metrics.MetricsRegistry()
    s = profiler.ProfileSession(profile_dir=str(tmp_path), registry=reg)
    with profiler.exclusive_profiler(activities=profiler._activities()):
        # another profiler of the process holds the lock: a triggered
        # capture answers as suppressed and gives its slot back, a forced
        # one raises; both are counted
        assert s.capture(ms=1) is None
        with pytest.raises(profiler.ProfilerBusy):
            with s.session(log_dir=str(tmp_path / "t"), force=True):
                pass
        with pytest.raises(profiler.ProfilerBusy):
            with profiler.exclusive_profiler():
                pass
    assert reg.export_state()["counters"][
        names.TELEMETRY_PROFILE_BUSY] == 2
    assert s.capture(ms=1) is not None


def test_default_ms_reads_the_env(monkeypatch):
    s = profiler.ProfileSession(profile_dir=None, max_ms=500.0)
    r = ref_prof.ProfileSession(profile_dir=None, max_ms=500.0)
    for raw in (None, "50", "9000", "bad", "0"):
        if raw is None:
            monkeypatch.delenv(profiler.PROFILE_MS_ENV, raising=False)
        else:
            monkeypatch.setenv(profiler.PROFILE_MS_ENV, raw)
        assert s.default_ms() == r.default_ms(), raw


# --------------------------------------------- a real capture on the CPU
def test_cpu_gbdt_fit_capture_has_host_region_rows(tmp_path):
    from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, 6)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    params = BoostParams(objective="binary", num_iterations=2, max_depth=3,
                         num_leaves=7, max_bin=15)
    ledger = profiler.RooflineLedger(compile_log=_Log())
    s = profiler.ProfileSession(profile_dir=str(tmp_path), ledger=ledger)
    profiler.get_roofline().clear()
    with s.session(reason="cpu-fit") as info:
        fit_booster(x, y, params, device="cpu")
    assert info["ops"] == [] and info["regions"] == {}
    assert info["device"]["device_events"] == 0
    # the reference's CPU backend gives the same empty device table
    assert ref_prof.parse_trace(str(tmp_path / "missing")) == []
    rows = profiler.get_roofline().rows()
    for region in ("gbdt.hist", "gbdt.split", "gbdt.route"):
        assert rows[region]["source"] == "host"
        assert rows[region]["occurrences"] == 2 * 3
        assert rows[region]["seconds"] > 0
    with open(os.path.join(info["path"], "regions.json")) as f:
        noted = json.load(f)["intervals"]
    assert sorted({row[4] for row in noted}) == [
        "gbdt.hist", "gbdt.route", "gbdt.split"]
