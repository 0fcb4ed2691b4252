"""The per-layer readers on a made-up trace: what each reads, and that a
reader with nothing to read returns None rather than 0."""

import pytest

from harness import spec
from harness.window import Window
from harness.trace import TraceContext, busy_us, device_ops_top, idle_gaps

K2 = "void (anonymous namespace)::tile_composite_kernel<32, 4, 1, false>(float4 const*, int)"
K1 = "void project_kernel(float const*, float const*)"
SORT = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>(int*)"


def _ctx(ops, work=None, checked=None, frames=2, window=(0.0, 1000.0)):
    return TraceContext(
        device_ops=ops,
        host_ops=[("frame", 0.0, 500.0), ("frame", 500.0, 1000.0),
                  ("cudaGraphLaunch", 300.0, 450.0)],
        window_us=window, frame_ms=[0.5] * frames, work=work or [],
        info={"capture_s": 0.25}, steady_frame_ms=0.5,
        checked=checked or [])


def _work(k2_flops, k3=None, frame_flops=0.0):
    w = {"k2": {"flops": k2_flops, "bytes": 0.0},
         "frame": {"flops": frame_flops, "bytes": 0.0}}
    if k3 is not None:
        w["k3"] = {"flops": k3, "bytes": 0.0}
    return w


OPS = [(SORT, 0.0, 100.0), (K2, 50.0, 250.0), (K1, 500.0, 550.0),
       ("Memcpy DtoD (Device -> Device)", 600.0, 700.0),
       (SORT, 2000.0, 2100.0)]                    # outside the window


def test_busy_and_gaps_merge_overlaps_and_clip_to_the_window():
    ctx = _ctx(OPS)
    assert busy_us(ctx) == 250.0 + 50.0 + 100.0
    gaps = idle_gaps(ctx)
    assert gaps[0] == ["frame", 300e-6]          # 700..1000, in a frame
    assert gaps[1] == ["cudaGraphLaunch", 250e-6]  # 250..500: innermost op
    top = dict(device_ops_top(ctx))
    assert top[SORT] == pytest.approx(100e-6)


def test_glue_is_every_operation_but_the_ports_kernels():
    read = spec.reader("glue_device_ms")
    assert read(_ctx(OPS)) == pytest.approx((100.0 + 100.0) / 1e3 / 2)
    assert read(_ctx([])) is None


def test_idle_share_uses_the_steady_frame_time():
    read = spec.reader("device_idle_pct")
    # 400 us busy over 2 frames = 0.2 ms a frame of the window's 0.5 ms
    assert read(_ctx(OPS)) == pytest.approx(60.0)


def test_steady_frame_time():
    read = spec.reader("steady_frame_ms")
    assert read(_ctx(OPS)) == 0.5
    ctx = _ctx(OPS)
    ctx.steady_frame_ms = 0.0
    assert read(ctx) is None


def test_roofline_is_least_time_over_device_time():
    k2 = spec.reader("k2_roofline")
    # 200 us of K2 over 2 frames; least time 2 x 6.7e9 flops / 67e12 = 200 us
    ctx = _ctx(OPS, work=[_work(6.7e9), _work(6.7e9)])
    assert k2(ctx) == pytest.approx(100.0)
    assert k2(_ctx(OPS, work=[_work(0.0)])) is None
    k3 = spec.reader("k3_roofline")
    assert k3(ctx) is None                       # no K3 in this trace
    tail = "void tail_chunk_kernel<64, 4>(float4 const*)"
    ctx3 = _ctx(OPS + [(tail, 800.0, 900.0)],
                work=[_work(1.0, k3=3.35e9)])
    assert k3(ctx3) == pytest.approx(50.0)


def test_mfu_reads_the_checked_frames():
    read = spec.reader("mfu.frame")
    ctx = _ctx(OPS, checked=[(_work(0, frame_flops=6.7e9), 1.0),
                             (_work(0, frame_flops=6.7e9), 3.0)])
    assert read(ctx) == pytest.approx(100.0 * 0.2e-3 / 4e-3)
    assert read(_ctx(OPS)) is None


def test_capture_seconds():
    read = spec.reader("capture_s")
    assert read(_ctx(OPS)) == 0.25
    ctx = _ctx(OPS)
    ctx.info = {"capture_s": 0.0}
    assert read(ctx) is None


def test_steady_ms_takes_the_windows_last_seconds():
    # frames start every 2 s for 6 s, then every 1 s; the window closes
    # at 10 s: its last 4 s hold the frames started at 6, 7, 8 and 9
    w = Window(starts=[0.0, 2.0, 4.0, 6.0, 7.0, 8.0, 9.0], end=10.0)
    assert w.steady_ms(4.0) == pytest.approx(1000.0)
    assert w.steady_ms(100.0) == pytest.approx(10000.0 / 7)
