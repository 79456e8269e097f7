"""The port's sparse-expert layers (models/moe.py, kernels/moe.py, the MoE
half of models/vit.py's Block, make_stage2_step's auxiliary loss) against
the plain float32 V-MoE of tests/plain_vmoe.py, on the CPU at a small size:
width 64, depth 4, 4 heads, 8 experts, top-2, MoE on layers 1 and 3, 32 px,
patch 8 (N 17), batch 4. Also the capacity rule on hand-made routings,
determinism, remat, the draws and launches of a dense config, and the
registry's V-MoE-L/16.

The `cuda`-marked tests hold the dispatch and combine kernels against
their eager path on the card (run without the repo's conftest there:
`python -m pytest --noconftest -m cuda tests/test_torch_moe.py`)."""

import math

import pytest
import torch

from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.kernels import moe as kmoe
from devit_tpu_torch.models import moe
from devit_tpu_torch.models.vit import VisionTransformer, create_vit, drop_path_masks, train_draws
from devit_tpu_torch.train.optim import OptimConfig, make_optimizer
from devit_tpu_torch.train.state import TrainState
from devit_tpu_torch.train.steps import make_dekd_step, make_ensemble_train_step, make_stage2_step

from plain_vmoe import draws as plain_draws
from plain_vmoe import forward as plain_forward
from plain_vmoe import stage2_loss as plain_stage2_loss
from plain_vmoe import strict_f32

B = 4
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=4, num_classes=10,
            num_experts=8, top_k=2, moe_layers=(1, 3), drop_path_rate=0.1)


def _cfg(**kw):
    return get_vit_config("vmoe_l16_e32", **{**TINY, **kw})


def _plain_cfg(cfg) -> dict:
    return {k: getattr(cfg, k) for k in (
        "img_size", "patch_size", "embed_dim", "depth", "num_heads", "num_experts", "top_k",
        "moe_layers", "capacity_ratio", "aux_loss_weight", "drop_path_rate", "layer_norm_eps")}


def _model(cfg=None, remat=True, seed=0):
    cfg = cfg or _cfg()
    m = VisionTransformer(cfg, dtype=torch.float32, use_kernel=True, use_remat=remat)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-zero biases and scales, so every leaf is exercised
        g = torch.Generator().manual_seed(seed + 100)
        for name, p in m.named_parameters():
            if name.endswith(("bias", "scale")):
                p.add_(0.02 * torch.randn(p.shape, generator=g))
    return m


def _params(m):
    return {k: p.detach().clone() for k, p in m.named_parameters()}


def _images(seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, 32, 32, 3), generator=g), torch.randint(0, 10, (B,), generator=g)


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def test_eval_logits_match_the_plain_reference():
    """f32 eval forward (no noise, no aux). Tolerance 1e-5 of the largest
    logit: the port's A&S erf (1.5e-7 absolute) and summation orders,
    against an exact-erf plain forward."""
    m = _model()
    x, _ = _images()
    with torch.no_grad():
        out = m(x)
        want, aux = plain_forward(_params(m), x, _plain_cfg(m.cfg))
    assert out.aux_loss is None and aux is None
    assert _rel(out.logits, want) < 1e-5


def test_train_logits_and_aux_loss_match_the_plain_reference():
    """A training forward with drop-path and router noise from the same
    generator: logits and aux_loss within 1e-5 relative (as above; aux is a
    ratio of sums of f32 softmaxes and normal tails)."""
    m = _model()
    x, _ = _images()
    with torch.no_grad():
        out = m(x, train=True, generator=torch.Generator().manual_seed(7))
        rates, keep, seeds = plain_draws(_plain_cfg(m.cfg), torch.Generator().manual_seed(7), B)
        want, aux = plain_forward(_params(m), x, _plain_cfg(m.cfg), train=True, keep=keep,
                                  rates=rates, seeds=seeds)
    assert _rel(out.logits, want) < 1e-5
    assert abs(float(out.aux_loss) - float(aux)) < 1e-5 * float(aux)


def _step_grads(m, images, labels, seed=7, smoothing=0.1):
    """(loss, aux, {leaf: gradient}) of one make_stage2_step step."""
    tx = make_optimizer(OptimConfig(lr=5e-4, weight_decay=0.05, opt="adamw", sched="cosine",
                                    epochs=10, warmup_epochs=1), 10)
    state = TrainState.create(m, tx)
    got = {}
    apply = state.apply_gradients
    state.apply_gradients = lambda grads: (got.update({k: g.clone() for k, g in grads.items()}),
                                           apply(grads))[1]
    step = make_stage2_step(m, None, mixup=None, smoothing=smoothing)
    _, metrics = step(state, None, images, labels, torch.Generator().manual_seed(seed))
    return metrics["loss"], metrics.get("aux_loss"), got


def test_stage2_step_gradients_of_every_leaf_match_the_plain_reference():
    """One stage-2 step (label smoothing, drop-path, router noise, λ aux):
    the loss within 1e-5 relative and every leaf's gradient, the router and
    the stacked experts included, within 1e-4 of the leaf's largest
    reference gradient (f32 through 4 layers' backward, with the A&S GELU's
    derivative against the exact one's)."""
    m = _model()
    images, labels = _images()
    params = _params(m)
    loss, aux, got = _step_grads(m, images, labels)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want_loss, want_aux = plain_stage2_loss(leaves, images, labels, _plain_cfg(m.cfg),
                                            torch.Generator().manual_seed(7), 0.1)
    grads = torch.autograd.grad(want_loss, list(leaves.values()))
    want_loss, want_aux = want_loss.detach(), want_aux.detach()
    assert abs(float(loss) - float(want_loss)) < 1e-5 * float(want_loss)
    assert abs(float(aux) - float(want_aux)) < 1e-5 * float(want_aux)
    assert set(got) == set(leaves)
    assert {"blocks.1.router.kernel", "blocks.3.experts.fc2.kernel"} <= set(got)
    for k, g in zip(leaves, grads):
        assert float(g.abs().max()) > 0, k
        assert _rel(got[k], g) < 1e-4, k


# ---- the capacity rule, on hand-made routings: (choices (T, K), experts,
# cap) -> tok_slot (T, K) (expert * cap + position, -1 dropped)
CAPACITY_CASES = {
    # expert 0 holds 2: tokens 1 and 2's first choices fill it before token
    # 0's second choice, which drops
    "second_choices_drop_before_first": ([[1, 0], [0, 1], [0, 1]], 2, 2,
                                         [[2, -1], [0, 3], [1, -1]]),
    # three first choices of expert 0 at cap 2: the latest token drops
    "later_tokens_drop_before_earlier": ([[0, 1], [0, 1], [0, 1]], 2, 2,
                                         [[0, 2], [1, 3], [-1, -1]]),
    # expert 1 and 3 receive nothing; their slots stay empty
    "an_expert_left_empty": ([[0, 2], [2, 0]], 4, 2, [[0, 5], [4, 1]]),
    # each expert takes the first first choice sent to it; every second
    # choice finds its expert full
    "a_cap_of_one": ([[0, 1], [1, 0], [0, 1]], 2, 1, [[0, -1], [1, -1], [-1, -1]]),
}


@pytest.mark.parametrize("case", sorted(CAPACITY_CASES))
def test_capacity_rule(case):
    choice, experts, cap, want = CAPACITY_CASES[case]
    tok_slot, slot_tok, routed = moe.slot_maps(torch.tensor(choice), experts, cap)
    assert tok_slot.tolist() == want
    inverse = [-1] * (experts * cap)
    for t, row in enumerate(want):
        for s in row:
            if s >= 0:
                inverse[s] = t
    assert slot_tok.tolist() == inverse
    assert routed.tolist() == [sum(row.count(e) for row in choice) for e in range(experts)]


def test_top_k_breaks_ties_to_the_lower_index():
    scores = torch.tensor([[0.0, 1.0, 1.0, 0.5], [2.0, 2.0, 2.0, 2.0], [0.0, 0.0, 3.0, 0.0]])
    assert moe.top_k(scores, 2).tolist() == [[1, 2], [0, 1], [2, 0]]


def test_capacity_is_rounded_from_the_group():
    assert moe.capacity(128 * 197, 2, 32, 1.05) == 1655
    assert moe.capacity(B * 17, 2, 8, 1.05) == 18


def test_dispatch_and_combine_match_their_dense_form_and_its_gradients():
    """The autograd functions (eager path) against the same layer written as
    index_select and index_add: values and both gradients within f32
    rounding (1e-6 of the largest)."""
    g = torch.Generator().manual_seed(3)
    T, C, E, cap = 40, 24, 4, 9
    choice = moe.top_k(torch.randn((T, E), generator=g), 2)
    tok_slot, slot_tok, _ = moe.slot_maps(choice, E, cap)
    x = torch.randn((T, C), generator=g, requires_grad=True)
    w = torch.rand((T, 2), generator=g, requires_grad=True)
    scale = torch.randn((E * cap, C), generator=g)
    y = moe.combine(moe.dispatch(x, tok_slot, slot_tok) * scale, w, tok_slot, slot_tok)
    dy = torch.randn((T, C), generator=g)
    dx, dw = torch.autograd.grad(y, [x, w], dy)
    xs, ws = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    want = torch.zeros(T, C)
    for j in range(2):
        s = tok_slot[:, j].long()
        kept = (s >= 0).float()[:, None]
        want = want + kept * ws[:, j:j + 1] * xs * scale[s.clamp_min(0)]
    want_dx, want_dw = torch.autograd.grad(want, [xs, ws], dy)
    assert (tok_slot == -1).any()  # some choices dropped at this cap
    for a, b in ((y, want), (dx, want_dx), (dw, want_dw)):
        assert _rel(a, b) < 1e-6


def test_kernel_wrappers_reject_other_dtypes():
    x = torch.zeros((4, 8), dtype=torch.float64)
    maps = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        kmoe.moe_gather(x, maps)
    with pytest.raises(TypeError):
        kmoe.moe_combine(x, maps.view(2, 2))
    with pytest.raises(TypeError):
        kmoe.moe_gather(x.float(), maps.long())


def test_two_runs_are_bit_equal():
    images, labels = _images()
    a = _step_grads(_model(), images, labels)
    b = _step_grads(_model(), images, labels)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def test_remat_draws_the_noise_again():
    """Remat on and off: the same loss and gradients, bit for bit (the
    recompute seeds the router noise from the same host seed), and the
    counters count the forward once."""
    images, labels = _images()
    on, off = _model(remat=True), _model(remat=False)
    a, b = _step_grads(on, images, labels), _step_grads(off, images, labels)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    assert moe.route_counts(on) == moe.route_counts(off)
    assert all(c["routed"] == 2 * B * 17 for c in moe.route_counts(on).values())


def test_route_counts_and_capture():
    m = _model()
    x, _ = _images()
    with torch.no_grad(), moe.capture_routing(m) as rec:
        m(x, train=True, generator=torch.Generator().manual_seed(7))
    counts = moe.route_counts(m)
    assert sorted(counts) == sorted(rec) == [1, 3]
    for i, (h, choice) in rec.items():
        assert h.shape == (B * 17, 64) and choice.shape == (B * 17, 2)
        tok_slot, _, routed = moe.slot_maps(choice, 8, moe.capacity(B * 17, 2, 8, 1.05))
        assert counts[i] == {"routed": 2 * B * 17, "dropped": int((tok_slot < 0).sum()),
                             "per_expert": routed.tolist()}
    moe.reset_route_counts(m)
    assert moe.route_counts(m)[1]["routed"] == 0


def test_a_dense_config_draws_and_launches_as_before(monkeypatch):
    """Without MoE layers train_draws draws exactly the drop-path masks (the
    generator ends where drop_path_masks alone leaves it) and a stage-2 step
    reaches no MoE code."""
    cfg = get_vit_config("dedeit", img_size=32, patch_size=8, embed_dim=64, depth=4,
                         num_heads=4, num_classes=10, drop_path_rate=0.1)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    seeds, masks, moe_seeds = train_draws(cfg, g1, B)
    want = drop_path_masks(g2, torch.linspace(0.0, 0.1, 4).tolist(), B)
    assert moe_seeds == {} and torch.equal(masks, want)
    assert torch.equal(g1.get_state(), g2.get_state())

    def boom(*a, **k):
        raise AssertionError("a dense model reached the MoE layer")

    monkeypatch.setattr("devit_tpu_torch.models.vit.moe_mlp", boom)
    launches = (kmoe.moe_gather.launches, kmoe.moe_combine.launches)
    m = VisionTransformer(cfg, dtype=torch.float32).reset_parameters(torch.Generator())
    images, labels = _images()
    loss, aux, _ = _step_grads(m, images, labels)
    assert aux is None and math.isfinite(float(loss))
    assert (kmoe.moe_gather.launches, kmoe.moe_combine.launches) == launches


def test_steps_that_take_no_moe_model_say_so():
    m = _model()
    with pytest.raises(ValueError, match="MoE"):
        make_dekd_step(m, m)
    with pytest.raises(ValueError, match="MoE"):
        make_ensemble_train_step(m, None)


def _param_count(cfg) -> int:
    with torch.device("meta"):
        return sum(p.numel() for p in VisionTransformer(cfg).parameters())


def test_the_registry_vmoe_l16_has_its_published_size():
    """V-MoE-L/16 Every-2, E 32: 3,426 M parameters in the backbone (the
    classifier head, 1,024 x classes, depends on the dataset), counted on
    the meta device; the benchmark's 100-class model 3,426.26 M."""
    cfg = get_vit_config("vmoe_l16_e32")
    assert cfg.moe_layers == tuple(range(1, 24, 2)) and cfg.num_experts == 32
    head = cfg.embed_dim * cfg.num_classes + cfg.num_classes
    assert abs(_param_count(cfg) - head - 3_426e6) < 1e6
    assert _param_count(cfg.replace(num_classes=100)) == 3_426_264_164


def test_create_vit_builds_on_the_device_it_is_given():
    m = create_vit("vmoe_l16_e32", device="cpu", **{k: v for k, v in TINY.items()})
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    assert m.blocks[1].experts.fc1.kernel.shape == (8, 64, 256)


# ---- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests hold the eager path")
    return torch.Generator(device="cuda").manual_seed(0)


def _routing(g, T, E, cap, K=2):
    choice = moe.top_k(torch.randn((T, E), generator=g, device="cuda"), K)
    return moe.slot_maps(choice, E, cap)[:2]


SHAPES = [(128 * 197, 1024, 32, 1655), (1000, 100, 8, 200), (77, 36, 5, 9), (64, 8, 4, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_equal_their_eager_path_bit_for_bit(shape, dtype):
    """The gather (plain and weighted) and the combine (weighted and weight
    1) bit for bit against the eager path; dw within f32 summation error
    (1e-5 of the largest: a warp reduction against torch's sum). Shapes: the
    cell's (T 25,216, C 1,024, E 32, cap 1,655), C not a multiple of 8 (the
    value-by-value path), a cap past every expert's fill."""
    g = _cuda()
    T, C, E, cap = shape
    tok_slot, slot_tok = _routing(g, T, E, cap)
    x = torch.randn((T, C), generator=g, device="cuda").to(dtype)
    buf = torch.randn((E * cap, C), generator=g, device="cuda").to(dtype)
    w = torch.rand((T, 2), generator=g, device="cuda")
    before = (kmoe.moe_gather.launches, kmoe.moe_combine.launches)
    pairs = [(kmoe.moe_gather(x, slot_tok), kmoe.reference_gather(x, slot_tok)),
             (kmoe.moe_gather(x, slot_tok, tok_slot, w),
              kmoe.reference_gather(x, slot_tok, tok_slot, w)),
             (kmoe.moe_combine(buf, tok_slot, w), kmoe.reference_combine(buf, tok_slot, w)),
             (kmoe.moe_combine(buf, tok_slot), kmoe.reference_combine(buf, tok_slot))]
    for got, want in pairs:
        assert got.dtype == dtype and torch.equal(got.view(torch.uint8 if dtype != torch.float32
                                                           else torch.int32),
                                                  want.view(torch.uint8 if dtype != torch.float32
                                                            else torch.int32))
    dw = kmoe.moe_combine_dw(x, buf, tok_slot)
    assert _rel(dw, kmoe.reference_combine_dw(x, buf, tok_slot)) < 1e-5
    assert (kmoe.moe_gather.launches, kmoe.moe_combine.launches) == (before[0] + 2,
                                                                       before[1] + 3)


@pytest.mark.cuda
def test_a_moe_step_on_the_card_launches_the_kernels_and_matches_the_cpu():
    """A remat'd f32 stage-2 step of the tiny model on the card: 2 MoE
    layers x (forward, recompute) x (gather, combine) + backward (one
    gather, two combines each); loss and every gradient against the plain
    reference on the card (the router noise is drawn by the card's
    generator there too; TF32 off), within the CPU test's 1e-5 and 1e-4."""
    _cuda()
    strict_f32()
    images, labels = (t.cuda() for t in _images())
    m = _model().cuda()
    leaves = {k: v.clone().requires_grad_(True) for k, v in _params(m).items()}
    before = (kmoe.moe_gather.launches, kmoe.moe_combine.launches)
    loss, aux, grads = _step_grads(m, images, labels)
    assert (kmoe.moe_gather.launches - before[0], kmoe.moe_combine.launches - before[1]) == \
        (2 * 2 + 2, 2 * 2 + 2 * 2)
    want, _ = plain_stage2_loss(leaves, images, labels, _plain_cfg(m.cfg),
                                torch.Generator().manual_seed(7), 0.1)
    want_grads = dict(zip(leaves, torch.autograd.grad(want, list(leaves.values()))))
    assert abs(float(loss) - float(want)) < 1e-5 * float(want)
    for k, g in grads.items():
        assert _rel(g, want_grads[k]) < 1e-4, k


@pytest.mark.cuda
def test_a_dense_step_on_the_card_launches_no_moe_kernel():
    _cuda()
    cfg = get_vit_config("dedeit", img_size=32, patch_size=8, embed_dim=64, depth=4,
                         num_heads=4, num_classes=10, drop_path_rate=0.1)
    m = VisionTransformer(cfg).reset_parameters(torch.Generator()).cuda()
    before = (kmoe.moe_gather.launches, kmoe.moe_combine.launches)
    images, labels = _images()
    _step_grads(m, images.cuda(), labels.cuda())
    assert (kmoe.moe_gather.launches, kmoe.moe_combine.launches) == before
