"""The plain reference against the port on its plain path, at a tiny size on
the CPU in float32: the served ensemble's logits, the stage-2 step's draws,
schedule, losses, gradients and update."""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.drivers import _serving, train_steps
from benchmark.reference import model as ref
from benchmark.reference import stage2
from portbench_tiny import tiny_cell


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_served_logits_match_the_gated_reference(seed):
    cell = tiny_cell("serve_ens4_batch", seed=seed)
    served = _serving.build(cell, _serving.core.Spans())
    try:
        images = served.pool[:7]
        got = served.engine.predict(images)
    finally:
        _serving.release(served)
    chosen = [(0, 7, 0.0, 0.0, got)]
    assert _serving.check(cell, chosen, served.pool)["logit_err"] < 1e-5


@pytest.mark.parametrize("seed", [5, 6, 7, 8])
def test_mixup_cutmix_and_drop_path_draws_match_the_port(seed):
    from devit_tpu_torch.data.mixup import MixupConfig, mixup_cutmix
    from devit_tpu_torch.models.vit import drop_path_masks

    mix = {"mixup_alpha": 0.8, "cutmix_alpha": 1.0, "prob": 1.0, "switch_prob": 0.5,
           "label_smoothing": 0.1}
    images = torch.randn(6, 16, 16, 3, generator=torch.Generator().manual_seed(seed))
    labels = torch.tensor([0, 3, 2, 3, 1, 0])
    g_port, g_ref = (torch.Generator().manual_seed(seed) for _ in range(2))
    want_x, want_t = mixup_cutmix(g_port, images, labels, MixupConfig(num_classes=4, **mix))
    got_x, got_t = stage2.mix_batch(g_ref, images, labels, mix, 4)
    torch.testing.assert_close(got_x, want_x, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_t, want_t, rtol=1e-6, atol=1e-7)
    rates = torch.linspace(0.0, 0.1, 5).tolist()
    want = drop_path_masks(g_port, rates, 6)
    assert torch.equal(stage2.drop_path_keep(g_ref, rates, 6), want.view(5, 2, 6))


def test_learning_rate_schedule_matches_the_port():
    from devit_tpu_torch.train.optim import OptimConfig, cosine_schedule

    opt = {"lr": 5e-4, "min_lr": 1e-5, "warmup_lr": 1e-6, "warmup_epochs": 5, "epochs": 100,
           "steps_per_epoch": 49}
    port = cosine_schedule(OptimConfig(lr=5e-4, min_lr=1e-5, warmup_lr=1e-6, warmup_epochs=5,
                                       epochs=100), 49)
    for step in (0, 1, 2, 244, 245, 246, 3000, 4899, 4900, 6000):
        assert stage2.lr_at(opt, step) == pytest.approx(port(step), rel=1e-6)


def test_stage2_steps_match_the_reference():
    cell = tiny_cell("train_stage2_224", seconds=0.3)
    out = train_steps.run(cell)
    assert out.numbers["loss_gap"] < 1e-5
    assert out.numbers["grad_gap"] < 2e-3 and out.numbers["change_gap"] < 2e-3


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.linspace(-3.0, 3.0, 1001)
    y = ref._round_fp8(x, torch.float8_e4m3fn)
    big = x.abs() > 3.0 / 64
    assert ((y - x).abs()[big] <= x.abs()[big] * 2 ** -4 + 1e-7).all()
    assert not torch.equal(y, x) and y.abs().max() == pytest.approx(3.0)


def test_policy_gates_keep_the_policy_counts():
    policy = {"heads": [[1, 0, 6]], "neurons": [[5, 0, 12]]}
    (head, neuron), = weights.policy_gates(policy, 3, 6, 12, seed=9)
    assert head.sum(1).tolist() == [1, 0, 6] and neuron.sum(1).tolist() == [5, 0, 12]
    (head2, _), = weights.policy_gates(policy, 3, 6, 12, seed=9)
    assert np.array_equal(head, head2)
