"""The yardstick's arithmetic: operations counted from shapes, the trace's
reduction to busy time, idle share and kernel time, the percentile and the
rates over the whole window."""

import math
import statistics

import pytest
from harness import devtrace, flops, readers, spec, window


def models(name):
    return spec.load_cell(name).config["cfg"]["models"]


def test_field_macs_match_the_hand_counts():
    # Width 256: 63*256 + 6*256^2 + (256+63)*256 + 256^2 + 256 + (256+27)*128 + 128*3.
    assert flops.field_macs(models("lego.train")["fine"]) == 593_408
    # Width 128: the same products at 128 (the view branch 64 wide).
    assert flops.field_macs(models("llff.train")["fine"]) == 157_440


def test_operations_per_ray_count_coarse_and_fine_points():
    cfg = spec.program_cfg(spec.load_cell("lego.train"), 1)
    assert flops.forward_flops_per_ray(cfg, train=True) == 2 * 593_408 * (64 + 64 + 128)
    cfg = spec.program_cfg(spec.load_cell("llff.render"), 1)
    assert flops.forward_flops_per_ray(cfg, train=False) == 2 * 157_440 * (64 + 64 + 64)


def op(name, start, dur, cat="kernel"):
    return devtrace.DeviceOp(name, cat, start, dur)


def test_union_and_idle_share_count_overlaps_once():
    assert devtrace.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    stretch = devtrace.Stretch([op("a", 0.0, 2.0), op("b", 1.0, 2.0), op("c", 5.0, 1.0)],
                               t0=0.0, t1=10.0)
    ctx = readers.TraceContext(stretch=stretch, units=2, forward_flops=1.0, window_s=1.0,
                               window_model_flops=1.0)
    assert readers.idle_percent(ctx) == pytest.approx(60.0)
    assert devtrace.idle_gaps(stretch.ops, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]


def test_kernel_names_as_the_trace_prints_them():
    names = {
        "void (anonymous namespace)::bwd_tile_kernel<256>((anonymous namespace)::BwdMaps, "
        "(anonymous namespace)::Desc)": "bwd_tile_kernel",
        "(anonymous namespace)::dw_kernel((anonymous namespace)::DwArgs)": "dw_kernel",
        "void (anonymous namespace)::fused_mlp_fwd_kernel<128>((anonymous namespace)::"
        "FieldMaps, float const*, long)": "fused_mlp_fwd_kernel",
        "void at::native::radixSortKVInPlace<2, -1, 32, 32, float, long, unsigned int>(at::"
        "cuda::detail::TensorInfo<float, unsigned int>)": "radixSortKVInPlace",
        "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
        "(anonymous namespace)::TensorListMetadata<2> >(int)": "multi_tensor_apply_kernel",
    }
    for name, fn in names.items():
        assert devtrace.kernel_id(name) == fn


def test_readers_attribute_kernels_by_name():
    ops = [op("void (anonymous namespace)::fused_mlp_fwd_kernel<256>(int)", 0.0, 0.004),
           op("(anonymous namespace)::dw_kernel(int)", 0.004, 0.003),
           op("void at::native::reduce_kernel<512>(int)", 0.007, 0.001),
           op("Memcpy DtoH", 0.008, 0.002, cat="gpu_memcpy")]
    ctx = readers.TraceContext(stretch=devtrace.Stretch(ops, 0.0, 0.01), units=2,
                               forward_flops=1e12, window_s=2.0, window_model_flops=989e12)
    # 2 units of 1 TFLOP in 4 ms of forward kernel: 5e14 FLOP/s of 989e12.
    assert readers.roofline(ctx, ("fused_mlp_fwd_kernel",), ctx.forward_flops) == pytest.approx(
        100.0 * 5e14 / 989e12)
    assert readers.roofline(ctx, ("absent_kernel",), 1.0) is None
    assert readers.other_kernels_ms(ctx, ("fused_mlp_fwd_kernel", "dw_kernel")) == pytest.approx(
        0.5)
    assert readers.mfu(ctx) == pytest.approx(50.0)
    assert readers.idle_percent(ctx) == pytest.approx(0.0)


def test_reduce_events_places_the_trace_on_the_host_clock():
    events = [
        {"ph": "X", "cat": "kernel", "name": "void at::native::spin_kernel(long)",
         "ts": 1_000_000.0, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 1_000_010.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1_000_500.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1_000_020.0, "dur": 5.0},
    ]
    stretch = devtrace.reduce_events(events, host_start=100.0, host_stop=100.001)
    assert [o.name for o in stretch.ops] == ["a", "Memcpy DtoH"]
    assert stretch.host_offset == pytest.approx(1.0 - 100.0)
    assert stretch.seconds == pytest.approx(0.001)
    spans = [("train_call", 100.0, 100.0002), ("metrics_read", 100.0002, 100.001)]
    out = devtrace.breakdown(stretch, spans)
    assert out["device_ops"][0] == ["a", pytest.approx(100e-6)]
    # Gaps, longest first: 450 us after the copy (in the metrics read), 390
    # us from "a" to the copy and 10 us from the marker to "a" (both begin in
    # the train call).
    assert [g[0] for g in out["idle_gaps"]] == ["metrics_read", "train_call", "train_call"]
    assert sum(g[1] for g in out["idle_gaps"]) == pytest.approx(0.00085)


def test_percentile_is_over_every_value():
    values = [float(v) for v in range(1, 101)]
    assert window.percentile(values, 90) == pytest.approx(
        statistics.quantiles(values, n=10, method="inclusive")[8])
    assert window.percentile([0.25], 90) == 0.25
    assert math.isclose(window.percentile(values, 50), statistics.median(values))
