"""The port's entry points of devit_tpu_torch/entry.py against the
JAX package's (__graft_entry__.py): entry()'s ensemble forward on the CPU,
held to the JAX ensemble forward on the same weights (bridged) at B 2, and
dryrun_multichip(4, "cpu") over four gloo ranks on the CPU.

Tolerance: both forwards compute in bf16 (the entry's dtype in both
packages), so logits agree within 2e-2 of their largest magnitude (the JAX
suite's bf16 tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from devit_tpu.models import create_vit as jax_create_vit
from devit_tpu.models.ensemble import EnsMLP as JEnsMLP
from devit_tpu.models.ensemble import ensemble_forward as jax_ensemble_forward
from devit_tpu_torch.entry import dryrun_multichip, entry
from devit_tpu_torch.io.bridge import ensmlp_to_jax_params, stacked_vit_to_jax_params


def test_entry_forward_matches_jax_on_cpu():
    torch.set_num_threads(2)
    fn, (stacked, ens_params, images) = entry("cpu")
    assert images.shape == (8, 224, 224, 3) and images.device.type == "cpu"
    assert next(iter(stacked.values())).shape[0] == 4
    x = images[:2]
    got = fn(stacked, ens_params, x).float().numpy()
    assert got.shape == (2, 100) and np.isfinite(got).all()

    model = jax_create_vit("dedeit", num_classes=25)
    ens = JEnsMLP(num_classes=100, sub_size=384, num_divisions=4, teacher_size=768,
                  family="deit")
    want = np.asarray(jax.jit(lambda s, e, im: jax_ensemble_forward(
        model, ens, {"params": s}, {"params": e}, im).logits)(
        stacked_vit_to_jax_params(stacked), ensmlp_to_jax_params(ens_params),
        jnp.asarray(x.numpy())), np.float32)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_dryrun_multichip_over_four_ranks(capsys):
    dryrun_multichip(4, "cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): layout={'div': 4, 'data': 1} loss=" in out
    assert out.count(" OK") == 4
    # the JAX dry run's placement on four devices: a division each, the
    # fusion on the first (no spare one)
    assert "on 4 devices the divisions take 4, the fusion the first (cpu:0) OK" in out
