"""The sparse-expert cell (train_vmoe_l16_224) on the CPU at a tiny size:
its files found by name, the benchmark's reference against the port's
eager path, the limits' controls and faults in the direction they must
go, the calibration script, and the readers on what a run hands them."""

import copy
import json
import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import core
from benchmark.drivers import train_moe_steps as d
from benchmark.metrics import _moe_counts
from portbench_tiny import BENCH, TINY, manifest

CELL = "train_vmoe_l16_224"
FROM_MANIFEST = core.Cell.from_manifest  # the calibration test patches it
READERS = ("mfu.moe", "moe_route_ms.moe", "moe_experts_ms.moe", "moe_move_ms.moe",
           "dropped_share.moe", "moe_gather_roofline.moe", "moe_combine_roofline.moe")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_moe_cell(seed: int = 2 ** 31 + 77, seconds: float = 1.0, **_) -> core.Cell:
    cell = FROM_MANIFEST(manifest(), CELL, seed=seed, seconds=seconds, device="cpu")
    cfg = copy.deepcopy(cell.config)
    cfg.update(TINY)
    cfg.update(moe_layers=[1], num_experts=4, dtype="float32")
    cfg["optimizer"] = {**cfg["optimizer"], "steps_per_epoch": 4}
    cell.config, cell.traffic = cfg, {**cell.traffic, "batch": 8, "img_size": 32}
    return cell


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(2)
    cell = tiny_moe_cell()
    out, got = d.drive(cell)
    want = d.reference_steps(cell, routing=got["routing"])
    return cell, out, got, want


def test_the_cell_files_are_found_by_name():
    m = manifest()
    w = {x["name"]: x for x in m["workloads"]}[CELL]
    traffic = core.load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    assert traffic["driver"] == "train_moe_steps" and traffic["batch"] == 128
    cfg = core.load_json(BENCH / "configs" / f"{w['config']}.json")
    assert cfg["reduced"] == [] and cfg["embed_dim"] == 1024 and cfg["num_experts"] == 32
    limits = core.load_json(BENCH / "limits" / f"{CELL}.json")
    assert set(limits) == {"loss_gap", "grad_gap", "change_gap", "route_disagree"}
    cell = core.Cell.from_manifest(m, CELL)
    assert [e["name"] for e in cell.end_to_end] == ["train_img_per_s", "setup_s"]
    assert sorted(x["name"] for x in cell.per_layer) == sorted(READERS)


def test_the_leaves_are_the_ports_parameters():
    from devit_tpu_torch.configs import get_vit_config
    from devit_tpu_torch.models.vit import VisionTransformer

    cfg = core.load_json(BENCH / "configs" / "vmoe_l16_e32.json")
    shapes = d.ref.leaf_shapes(cfg)
    vcfg = get_vit_config(cfg["model"], num_classes=cfg["num_classes"])
    with torch.device("meta"):
        named = {k: tuple(p.shape) for k, p in VisionTransformer(vcfg).named_parameters()}
    assert named == shapes
    assert sum(math.prod(s) for s in shapes.values()) == 3_426_264_164


def test_the_reference_follows_the_port(run):
    """f32 on both sides: the port's eager path against the benchmark's
    plain reference, routed by the port's choices."""
    cell, out, got, want = run
    nums = d.numbers(got, want, d.before_leaves(cell))
    assert nums["route_disagree"] == 0.0
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-5 and nums["change_gap"] < 1e-3
    assert out.e2e["train_img_per_s"] > 0 and out.attempted > 0


@pytest.mark.parametrize("fault", ["half", "frozen"])
def test_a_planted_fault_reads_far_off(run, fault):
    cell, _, got, want = run
    bad = d.reference_steps(cell, fault=fault, routing=got["routing"])
    nums = d.numbers(bad, want, d.before_leaves(cell))
    if fault == "frozen":
        assert nums["change_gap"] == 1.0
    else:
        assert nums["grad_gap"] > 0.1 and nums["loss_gap"] > 1e-3


def test_routing_by_the_noiseless_logits_disagrees():
    from benchmark.calibrate_moe import noiseless_routing
    from devit_tpu_torch.models import moe

    cell = tiny_moe_cell()
    undo = noiseless_routing(moe)
    try:
        _, got = d.drive(cell)
    finally:
        undo()
    want = d.reference_steps(cell, routing=got["routing"])
    assert d.numbers(got, want, d.before_leaves(cell))["route_disagree"] > 0.005


def test_the_calibration_prints_every_reading(monkeypatch, capsys):
    from benchmark import calibrate_moe

    monkeypatch.setattr(core.Cell, "from_manifest",
                        classmethod(lambda cls, m, w, seed, seconds: tiny_moe_cell(seed, seconds)))
    monkeypatch.setattr("sys.argv", ["calibrate_moe.py", "--workload", CELL, "--seeds", "5,6",
                                     "--seconds", "0.5", "--faults", "1"])
    assert calibrate_moe.main() == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [5, 6]
    assert {"program", "control", "half", "frozen", "noiseless"} <= set(lines[0])
    assert "half" not in lines[1] and lines[0]["frozen"]["change_gap"] == 1.0


def test_the_readers_read_a_run_and_nothing_where_there_is_nothing(run):
    _, out, _, _ = run
    for name in READERS:
        reader = core.load_module(BENCH / "metrics" / f"{name}.py")
        assert reader.read({}) is None, name
        assert reader.read({"config": {"moe_layers": []}, "steps": 3, "trace": None}) is None
    ctx = out.ctx
    share = core.load_module(BENCH / "metrics" / "dropped_share.moe.py").read(ctx)
    counts = ctx["route_counts"][1]
    assert share == pytest.approx(100.0 * counts["dropped"] / counts["routed"])
    assert 0 < core.load_module(BENCH / "metrics" / "mfu.moe.py").read(ctx) < 100


def test_span_and_roofline_readers_on_a_made_up_slice(run):
    _, out, _, _ = run
    trace = SimpleNamespace(lo=0.0, hi=10.0, ops_in=lambda lo, hi: [
        ("void moe_gather_rows<bf16>", 1.0, 1.002), ("moe_combine_rows", 2.0, 2.004),
        ("gemm", 3.0, 4.0)])
    ctx = {**out.ctx, "trace": trace, "traced_steps": 2,
           "moe_span_kernel_s": {"moe.route": 0.005, "moe.dispatch": 0.001,
                                 "moe.combine": 0.002}}
    assert core.load_module(BENCH / "metrics" / "moe_route_ms.moe.py").read(ctx) == 2.5
    assert core.load_module(BENCH / "metrics" / "moe_move_ms.moe.py").read(ctx) == 1.5
    assert core.load_module(BENCH / "metrics" / "moe_experts_ms.moe.py").read(ctx) is None
    cfg, share = ctx["config"], _moe_counts.kept_share(ctx)
    want = 100 * 2 * _moe_counts.gather_bytes(cfg, ctx["batch"], share) / 3.35e12 / 0.002
    got = core.load_module(BENCH / "metrics" / "moe_gather_roofline.moe.py").read(ctx)
    assert got == pytest.approx(want, rel=1e-6)


def test_remat_counts_both_forward_passes_of_the_moves():
    """Under remat the dispatch and the combine run forward twice a step
    (the recompute), and their bytes count twice."""
    cfg = core.load_json(BENCH / "configs" / "vmoe_l16_e32.json")
    once = {**cfg, "use_remat": False}
    T, K, S, C = _moe_counts.group(cfg, 128)
    dispatch = 12 * (T * K * C * 2 + S * C * 2 + S * 4)
    forward = 12 * (T * K * C * 2 + 2 * T * K * 4 + T * C * 2)
    assert _moe_counts.gather_bytes(cfg, 128, 1.0) - _moe_counts.gather_bytes(once, 128, 1.0) \
        == pytest.approx(dispatch)
    assert _moe_counts.combine_bytes(cfg, 128, 1.0) - _moe_counts.combine_bytes(once, 128, 1.0) \
        == pytest.approx(forward)


def test_span_time_counts_the_kernels_launched_inside_each_span():
    """launched_in sums the kernels the profiler linked to a span's range and
    to the operations under it, and nothing launched outside."""
    k = lambda us: SimpleNamespace(duration=us)
    op = lambda name, kernels=(), children=(): SimpleNamespace(
        name=name, kernels=list(kernels), cpu_children=list(children))
    route = op("moe.route", [k(1.0)], [op("aten::mm", [k(4.0)], [op("aten::x", [k(2.0)])])])
    again = op("moe.route", children=[op("aten::softmax", [k(3.0)])])
    events = [route, again, op("moe.experts", [k(50.0)]), op("aten::add", [k(100.0)])]
    got = _moe_counts.launched_in(events, _moe_counts.SPANS)
    assert got == pytest.approx({"moe.route": 10e-6, "moe.experts": 50e-6})


def test_the_forward_flops_of_an_image():
    """V-MoE-L/16 at 224 px: 162.9 GFLOP, 79.3 of them the experts'."""
    cfg = core.load_json(BENCH / "configs" / "vmoe_l16_e32.json")
    assert _moe_counts.flops_per_image(cfg) / 1e9 == pytest.approx(162.9, abs=0.05)
    dense = {**cfg, "top_k": 0}
    assert (_moe_counts.flops_per_image(cfg) - _moe_counts.flops_per_image(dense)) / 1e9 \
        == pytest.approx(79.3, abs=0.05)
