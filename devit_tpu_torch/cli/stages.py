"""The pipeline stages as CLI subcommands (counterpart of
devit_tpu/cli/stages.py): split, train_sub, shrink, distill, ensemble,
pipeline, deploy, convert and ingest, with the JAX CLI's flags, artifacts
and file layout (shrinked_policy.npy/shrinked_accuracy.npy, checkpoint +
checkpoint_temp, result.txt, log_stats.txt, compact.msgpack,
deploy_report.json), on one CUDA device (or the CPU with --device cpu), or
on several ranks (cli/common.py): stages 2-4 and the stage-3 policy
evaluation data-parallel, stage 5 over the ('div', 'data') layout, where
the JAX CLI places its meshes. Rank 0 writes every file; each stage ends
at a barrier, so the next stage's ranks read what it wrote.

Checkpoints are the JAX package's msgpack trees, so either CLI resumes or
continues from the other's artifacts. Both model families run (the CCT
family's deploy is skipped, as in the JAX CLI); --ckpt-format orbax raises.
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch

from devit_tpu_torch.cli import common as C
from devit_tpu_torch.core.rank import attn_head_rank, build_gates, mlp_neuron_rank
from devit_tpu_torch.core.shrink import model_shrink
from devit_tpu_torch.data.datasets import BatchIterator, build_dataset, pad_batch_to_steady
from devit_tpu_torch.data.pipeline import eval_transform
from devit_tpu_torch.data.splitter import DivisionManifest
from devit_tpu_torch.io.bridge import ensmlp_from_jax_params, vit_values_from_jax_params
from devit_tpu_torch.io.checkpoint import restore_pytree
from devit_tpu_torch.models.cct import CCT
from devit_tpu_torch.models.ensemble import (
    EnsembleCCT, EnsMLP, features_param_names, init_multivit, stack_division_gates,
    stack_division_params,
)
from devit_tpu_torch.models.vit import Gates, full_gates, map_leaves
from devit_tpu_torch.parallel import mesh as M
from devit_tpu_torch.runtime import is_main_process
from devit_tpu_torch.train import steps as S
from devit_tpu_torch.train.loop import fit, run_eval
from devit_tpu_torch.train.optim import make_optimizer
from devit_tpu_torch.train.state import (
    TrainState, restore_stage2_tree, restore_stage5_tree, stage2_tree, stage4_tree,
    stage5_tree,
)


def _gates_on(gates: Gates, device) -> Gates:
    return Gates(*(torch.as_tensor(np.asarray(a, np.float32), device=device) for a in gates))


def _try_resume(args, state, log):
    """Restore {params, ema_params, opt_state, epoch} from --resume (the
    checkpoint_temp.msgpack written every epoch, train_subdata.py:450-459).
    Returns (state, start_epoch)."""
    if not args.resume:
        return state, 0
    state, start_epoch = restore_stage2_tree(state, restore_pytree(args.resume))
    log.info(f"resumed from {args.resume} at epoch {start_epoch}")
    return state, start_epoch


def _snapshot(state):
    """Copies of a state's optimizer state and EMA: what a failed full
    restore must put back (_put_back)."""
    ema = None if state.ema_params is None else dict(state.ema_params)
    return copy.deepcopy(state.opt_state), copy.deepcopy(ema)


def _put_back(state, snapshot) -> None:
    opt, ema = snapshot
    state.opt_state.clear()
    state.opt_state.update(opt)
    if ema is not None:
        state.ema_params.update(ema)


def _try_resume_ensemble(args, bb_state, ens_state, log):
    """Restore both states (params, optimizer states, EMA) and the epoch
    from --resume (ensemble.py:390-402), as the JAX CLI does: the gated or
    gate-less checkpoint alike (the port restores by name, so a gated
    checkpoint resumes an ungated run and the other way round); a checkpoint
    whose optimizer states do not fit the run's optimizer (another family, a
    clip setting, a weights-only file) resumes the params only, with the JAX
    CLI's WARNING. A file that is not an ensemble checkpoint raises. Returns
    (bb_state, ens_state, start_epoch)."""
    if not getattr(args, "resume", None):
        return bb_state, ens_state, 0
    tree = restore_pytree(args.resume)
    if not isinstance(tree, dict) or "backbone_params" not in tree or "ens_params" not in tree:
        raise RuntimeError(f"{args.resume} is not an ensemble checkpoint (keys: "
                           f"{sorted(tree) if isinstance(tree, dict) else type(tree)})")
    snapshots = [_snapshot(bb_state), _snapshot(ens_state)]
    try:
        for key in ("bb_opt_state", "ens_opt_state"):
            if tree.get(key) is None:
                raise KeyError(key)
        bb_state, ens_state, start_epoch = restore_stage5_tree(bb_state, ens_state, tree)
        log.info(f"resumed ensemble (params, optimizer states, EMA) from {args.resume}")
    except Exception as e:
        for st, snap in zip((bb_state, ens_state), snapshots):
            _put_back(st, snap)
        params_only = {k: tree[k] for k in ("backbone_params", "ens_params", "epoch")
                       if k in tree}
        bb_state, ens_state, start_epoch = restore_stage5_tree(bb_state, ens_state, params_only)
        log.info(f"WARNING: resumed PARAMS ONLY from {args.resume} — optimizer "
                 f"states could not be restored ({type(e).__name__}: {e}); "
                 "Adam moments and schedule restart from zero")
    log.info(f"resuming ensemble at epoch {start_epoch}")
    return bb_state, ens_state, start_epoch


def _train_batches(args, train_ds, host_tf):
    def batches(epoch):
        it = BatchIterator(train_ds, args.batch_size, shuffle=True, seed=args.seed,
                           repeated_aug=3 if args.repeated_aug else 0, host_transform=host_tf)
        it.set_epoch(epoch)
        return it

    return batches


def _val_batches(args, val_ds):
    return BatchIterator(val_ds, args.eval_batch_size, shuffle=False, drop_last=False)


# ------------------------------------------------------------------ split


def split_main(args) -> str:
    """Stage 1: build + save the division manifest (splite_dataset.py:29-176,
    a manifest instead of file copies)."""
    log = C.setup(args)
    from devit_tpu_torch.data.datasets import DATASET_NUM_CLASSES

    if args.dataset.startswith("synthetic"):
        num_classes = int(args.dataset.split(":")[1]) if ":" in args.dataset else 100
    else:
        num_classes = DATASET_NUM_CLASSES.get(args.dataset)
        if num_classes is None:
            # INAT/INAT19: read categories.json alone, not the whole split
            from devit_tpu_torch.data.fine_grained import inat_num_classes

            num_classes = inat_num_classes(args.data_path,
                                           getattr(args, "inat_category", "name"))
    manifest = DivisionManifest.create(num_classes, args.num_division, seed=42)
    out = os.path.join(args.output_dir, f"division{args.num_division}")
    path = os.path.join(out, "manifest.json")
    if is_main_process():
        os.makedirs(out, exist_ok=True)
        manifest.save(path)
        log.info(f"wrote {path}: {args.num_division} divisions over {num_classes} classes")
        for i, d in enumerate(manifest.divisions):
            log.info(f"  division {i}: {len(d)} classes")
        if getattr(args, "materialize", False):
            from devit_tpu_torch.data.splitter import materialize_imagefolder

            materialize_imagefolder(manifest, args.data_path, out,
                                    link=not getattr(args, "materialize_copy", False), log=log)
    C.barrier()
    return path


# ------------------------------------------------------------------ train_sub


def train_sub_main(args) -> float:
    """Stage 2: finetune one division's sub-model (train_subdata.py:320-503)."""
    log = C.setup(args)
    device, dtype = C.device_from_args(args), C.dtype_from_args(args)
    train_full, val_full, manifest = C.build_division_data(args)
    div = args.start_division
    train_ds = train_full.division_view(manifest, div)
    val_ds = val_full.division_view(manifest, div)
    num_classes = train_ds.num_classes
    log.info(f"division {div}: {len(train_ds)} train / {len(val_ds)} val, {num_classes} classes")

    model = C.build_model(args.model, num_classes, args, seed=args.seed)
    if args.model_path:
        C.load_params_for(model, args.model_path, log)
    layout = C.parallel_context(log)
    if layout is not None:
        M.replicate_tree(dict(model.named_parameters()), layout)

    teacher = None
    if args.distillation_type != "none":
        if not args.teacher_path:
            # a random-init teacher would pull half the loss toward noise
            raise ValueError(f"--distillation-type {args.distillation_type} requires "
                             "--teacher-path (a trained teacher checkpoint)")
        teacher = C.build_model(args.teacher_model, num_classes, args)
        C.load_params_for(teacher, args.teacher_path, log)

    steps_per_epoch = C.train_steps_per_epoch(train_ds, args)
    tx = make_optimizer(C.optim_config_from_args(args, args.batch_size), steps_per_epoch)
    state = TrainState.create(model, tx, use_ema=args.model_ema, ema_decay=args.model_ema_decay)

    aug_cfg = C.augment_config_from_args(args, args.input_size, train_ds.images.shape[1])
    mix_cfg = C.mixup_config_from_args(args, num_classes)
    prep_train, host_tf = C.make_train_pipeline(args, aug_cfg, dtype, device)
    prep_eval = C.make_eval_prepare(args.input_size, dtype, device)
    step = S.make_stage2_step(
        model, teacher, mixup=mix_cfg, smoothing=args.smoothing,
        distillation_type=args.distillation_type, distillation_alpha=args.distillation_alpha,
        distillation_tau=args.distillation_tau, distill_token=args.distillation_token,
        layout=layout)

    def step_fn(state, images, labels, generator):
        x = prep_train(generator, images)
        return step(state, None, x, C.batch_to(labels, device), generator)

    eval_step = S.make_eval_step(model, layout)

    def eval_fn(state):
        # the live params, not the EMA (train_subdata.py:468)
        return run_eval(eval_step, None, None, _val_batches(args, val_ds), prepare=prep_eval)

    save = C.make_saver(args)

    def save_state(path, state, epoch):
        save(path, stage2_tree(state, epoch))

    state, start_epoch = _try_resume(args, state, log)
    if args.eval:
        m = eval_fn(state)
        log.info(f"eval only: acc1 {m['acc1']:.2f}")
        return m["acc1"]

    state, best = fit(
        carry=state, step_fn=step_fn, train_batches_fn=_train_batches(args, train_ds, host_tf),
        eval_fn=eval_fn, epochs=args.epochs,
        generator=torch.Generator().manual_seed(args.seed + 1), output_dir=args.output_dir,
        log_fn=log.info, save_state_fn=save_state, profile_dir=getattr(args, "profile_dir", None),
        tensorboard=getattr(args, "tensorboard", False), start_epoch=start_epoch)
    log.info(f"best acc1: {best:.2f}")
    C.barrier()
    return best


# ------------------------------------------------------------------ shrink


def shrink_main(args):
    """Stage 3: HSIC rank + MACs-constrained policy search (shrink.py:203-418)."""
    log = C.setup(args)
    device, dtype = C.device_from_args(args), C.dtype_from_args(args)
    train_full, val_full, manifest = C.build_division_data(args)
    div = args.start_division
    train_ds = train_full.division_view(manifest, div)
    val_ds = val_full.division_view(manifest, div)

    model = C.build_model(args.model, train_ds.num_classes, args)
    cfg = model.cfg
    if args.model_path:
        C.load_params_for(model, args.model_path, log)
    prep_eval = C.make_eval_prepare(args.input_size, dtype, device)
    # data-parallel policy evaluation (the reference wraps this stage in DDP
    # too, shrink.py:337-339); the one-batch ranking runs whole on every rank
    layout = C.parallel_context(log)

    # one train batch for ranking (imp_rank.py:21-23)
    images, _ = C.first_train_batch(train_ds, args.batch_size, seed=args.seed)
    x = prep_eval(images)
    neuron_rank = mlp_neuron_rank(model, x)
    head_rank = attn_head_rank(model, x)
    log.info(f"ranked {neuron_rank.shape} neurons, {head_rank.shape} heads")

    def val_batches():
        # raw host batches: evaluate_policies pads the ragged tail first
        for imgs, labels in _val_batches(args, val_ds):
            yield imgs, np.asarray(labels)

    # the reference's 9.19 anchor and seq 197 hold for the canonical dedeit
    # geometry only (shrink_imp.py:75,144); any other geometry budgets at its
    # true sequence length (a CCT's from its tokenizer: 64 at 32 px)
    canonical = cfg.depth == 12 and cfg.embed_dim == 384 and cfg.num_heads == 6
    seq_length = 197 if canonical else C.model_seq_length(cfg)
    result = model_shrink(
        model, neuron_rank, head_rank, val_batches, layer=cfg.depth,
        shrink_ratio=args.shrink_ratio, population=args.population, lb=args.lb, ub=args.ub,
        emb=cfg.embed_dim, head=cfg.num_heads, seq_length=seq_length, mlp_ratio=cfg.mlp_ratio,
        full_gmacs=9.19 if canonical else None, candidate_chunk=args.candidate_chunk,
        seed=args.seed, log=log, prepare=lambda t: eval_transform(t, args.input_size, dtype),
        layout=layout)
    if is_main_process():
        np.save(os.path.join(args.output_dir, "shrinked_policy.npy"), result.policies)
        np.save(os.path.join(args.output_dir, "shrinked_accuracy.npy"), result.accuracies)
        np.save(os.path.join(args.output_dir, "neuron_rank.npy"), neuron_rank)
        np.save(os.path.join(args.output_dir, "head_rank.npy"), head_rank)
    log.info(f"best policy acc {result.accuracies.max():.2f} -> {args.output_dir}")
    C.barrier()
    return result


# ------------------------------------------------------------------ distill (DEKD)


def distill_main(args) -> float:
    """Stage 4: DEKD (distill_sub.py:243-478 + engine.train_1epoch_qkv)."""
    log = C.setup(args)
    device, dtype = C.device_from_args(args), C.dtype_from_args(args)
    train_full, val_full, manifest = C.build_division_data(args)
    div = args.start_division
    train_ds = train_full.division_view(manifest, div)
    val_ds = val_full.division_view(manifest, div)
    num_classes = train_ds.num_classes

    if not args.teacher_path:
        # the relation losses match the teacher's middle-layer q/k/v: a
        # random-init teacher corrupts the student (distill_sub.py:229-230)
        raise ValueError("distill (DEKD) requires --teacher-path: the relation losses match "
                         "the teacher's middle-layer Q/K/V (engine.py:91-106); the pipeline "
                         "subcommand wires this automatically")
    teacher = C.build_model(args.teacher_model, num_classes, args)
    C.load_params_for(teacher, args.teacher_path, log)

    # the student gets resize heads to the teacher's width when
    # token-distilling (distill_sub.py:211-221)
    resize_dim = teacher.cfg.embed_dim if args.distillation_token else None
    student = C.build_model(args.model, num_classes, args, resize_dim=resize_dim,
                               seed=args.seed)
    if args.model_path:
        C.load_params_for(student, args.model_path, log)
    layout = C.parallel_context(log)
    if layout is not None:
        M.replicate_tree(dict(student.named_parameters()), layout)

    # shrink policy: the argmax-accuracy row; the first L entries are the
    # neuron sparsity, the next L the head sparsity (distill_sub.py:384-389)
    L = student.cfg.depth
    prep_eval = C.make_eval_prepare(args.input_size, dtype, device)
    if args.policy_path:
        policies = np.load(os.path.join(args.policy_path, "shrinked_policy.npy"))
        accs = np.load(os.path.join(args.policy_path, "shrinked_accuracy.npy"))
        best = policies[int(np.argmax(accs))]
        neuron_sparsity, head_sparsity = best[:L], best[L:2 * L]
        rank_file = os.path.join(args.policy_path, "neuron_rank.npy")
        if os.path.exists(rank_file):
            # stage 3 persists its ranks: the gates here are exactly the ones
            # the chosen policy's accuracy was measured with
            neuron_rank = np.load(rank_file)
            head_rank = np.load(os.path.join(args.policy_path, "head_rank.npy"))
        else:
            # a reference-made stage-3 output: re-rank on one batch
            # (distill_sub.py:391-401), heads on the neuron-gated network
            images, _ = C.first_train_batch(train_ds, args.batch_size)
            x = prep_eval(images)
            neuron_rank = mlp_neuron_rank(student, x)
            ngates = build_gates(neuron_rank,
                                 np.tile(np.arange(student.cfg.num_heads), (L, 1)),
                                 neuron_sparsity, np.zeros(L))
            head_rank = attn_head_rank(student, x, gates=_gates_on(ngates, device))
        gates = build_gates(neuron_rank, head_rank, neuron_sparsity, head_sparsity)
        log.info(f"applied shrink policy: mean neuron sparsity {np.mean(neuron_sparsity):.2f}, "
                 f"head {np.mean(head_sparsity):.2f}")
    else:
        gates = full_gates(student.cfg).numpy()
    gates = _gates_on(gates, device)

    steps_per_epoch = C.train_steps_per_epoch(train_ds, args)
    tx = make_optimizer(C.optim_config_from_args(args, args.batch_size), steps_per_epoch)
    state = TrainState.create(student, tx, use_ema=args.model_ema,
                              ema_decay=args.model_ema_decay)

    aug_cfg = C.augment_config_from_args(args, args.input_size, train_ds.images.shape[1])
    mix_cfg = C.mixup_config_from_args(args, num_classes)
    prep_train, host_tf = C.make_train_pipeline(args, aug_cfg, dtype, device)
    step = S.make_dekd_step(
        student, teacher, gamma=tuple(args.gama), mixup=mix_cfg, smoothing=args.smoothing,
        distillation_type=args.distillation_type, distillation_alpha=args.distillation_alpha,
        distillation_tau=args.distillation_tau,
        distillation_inter=getattr(args, "distillation_inter", True), layout=layout)

    def step_fn(state, images, labels, generator):
        x = prep_train(generator, images)
        return step(state, None, gates, x, C.batch_to(labels, device), generator)

    eval_step = S.make_eval_step(student, layout)

    def eval_fn(state):
        # the live params, not the EMA (distill_sub.py:435)
        return run_eval(eval_step, None, gates, _val_batches(args, val_ds), prepare=prep_eval)

    save = C.make_saver(args)

    def save_state(path, state, epoch):
        save(path, stage4_tree(state, epoch, gates))

    state, start_epoch = _try_resume(args, state, log)
    state, best = fit(
        carry=state, step_fn=step_fn, train_batches_fn=_train_batches(args, train_ds, host_tf),
        eval_fn=eval_fn, epochs=args.epochs,
        generator=torch.Generator().manual_seed(args.seed + 1), output_dir=args.output_dir,
        log_fn=log.info, save_state_fn=save_state, profile_dir=getattr(args, "profile_dir", None),
        tensorboard=getattr(args, "tensorboard", False), start_epoch=start_epoch)
    log.info(f"DEKD best acc1: {best:.2f}")
    C.barrier()
    return best


# ------------------------------------------------------------------ ensemble


def _ensemble_eval_compact(args, log, val_ds, num_classes, D) -> float:
    """Collaborative-inference eval from the deploy stage's compact
    artifacts through the serving path's forward, the collaborative server
    (parallel/serve.py: bf16 with fast_math, the fusion head at bf16) and
    its lag-2 stream: a division a card with --device cuda and several
    visible cards in one process, as the JAX CLI does, else on the rank's
    own device."""
    from devit_tpu_torch.models.compact_vit import load_compact
    from devit_tpu_torch.parallel.serve import make_collaborative_server, serving_devices

    device = C.device_from_args(args)
    cms = [load_compact(os.path.join(args.compact_path, f"sub-dataset{i}", "compact.msgpack"),
                        device=device) for i in range(D)]
    sub_size = cms[0].pos_embed.shape[-1]
    # the family from the artifact: undistilled backbones emit no dist token
    family = "deit" if cms[0].distilled else "vit"
    if args.ens_path:
        ckpt = restore_pytree(args.ens_path)
        ens = ensmlp_from_jax_params(ckpt.get("ens_params", ckpt.get("params", ckpt)),
                                     num_divisions=D, device=device)
    else:
        ens = EnsMLP(num_classes=num_classes, sub_size=sub_size, num_divisions=D,
                     teacher_size=args.teacher_size, family=family)
        ens = ens.reset_parameters(torch.Generator().manual_seed(0)).to(device)
    use_kernel = getattr(args, "use_pallas", None)
    use_kernel = device.type == "cuda" if use_kernel is None else use_kernel
    prep_eval = C.make_eval_prepare(args.input_size, C.dtype_from_args(args), device)

    totals = {"top1": 0, "top5": 0, "count": 0}
    metas = []  # (labels, n real rows) of each batch, in order

    def prepared():
        batch_size = args.eval_batch_size
        for imgs, labels in _val_batches(args, val_ds):
            # the ragged tail padded to the steady shape, as run_eval does
            imgs, labels, batch_size, n = pad_batch_to_steady(imgs, labels, batch_size)
            metas.append((np.asarray(labels)[:n], n))
            yield prep_eval(imgs)

    fwd = make_collaborative_server(
        cms, lambda ev, c, t: torch.func.functional_call(ens, ev, (c, t)),
        dict(ens.named_parameters()), patch_size=args.patch_size,
        devices=serving_devices(device), use_kernel=use_kernel)
    if len(set(fwd.division_devices)) > 1:
        log.info(f"collaborative serving: divisions on "
                 f"{[str(d) for d in fwd.division_devices]}, fusion on {fwd.fusion_device}")
    outputs = fwd.stream(dict(ens.named_parameters()), prepared(), depth=2)
    with torch.inference_mode():
        for logits in outputs:
            labels, n = metas.pop(0)
            logits = logits[:n]
            pred = np.argsort(-logits, axis=-1)
            totals["top1"] += int((pred[:, 0] == labels).sum())
            k = min(5, logits.shape[-1])
            totals["top5"] += int((pred[:, :k] == labels[:, None]).any(-1).sum())
            totals["count"] += len(labels)
    n = max(totals["count"], 1)
    acc1 = 100 * totals["top1"] / n
    log.info(f"compact ensemble eval: acc1 {acc1:.2f} acc5 {100 * totals['top5'] / n:.2f} "
             f"({totals['top1']} of {totals['count']})")
    return acc1


def _run_ensemble_training(args, log, train_ds, val_ds, num_classes, D, backbone, stacked,
                           ens, teacher, gates, label: str = "ensemble") -> float:
    """The stage-5 training tail of both families: dual optimizers + dual
    EMA (ensemble.py:315-348), resume, the train/eval/save loops. The steps
    are the CCT family's where `backbone` is a CCT."""
    device, dtype = C.device_from_args(args), C.dtype_from_args(args)
    steps_per_epoch = C.train_steps_per_epoch(train_ds, args)
    # two optimizers, backbone lr vs ens lr (ensemble.py:343-348); --ens-lr 0
    # freezes the fusion head
    bb_cfg = C.optim_config_from_args(args, args.batch_size)
    ens_lr = args.ens_lr if args.ens_lr is not None else args.lr
    ens_cfg = type(bb_cfg)(**{**bb_cfg.__dict__, "lr": ens_lr})
    layout = C.parallel_context(log, num_divisions=D)
    if layout is not None:
        M.replicate_tree(stacked, layout)
        M.replicate_tree(dict(ens.named_parameters()), layout)
    bb_state = TrainState.create(stacked, make_optimizer(bb_cfg, steps_per_epoch),
                                 use_ema=args.model_ema, ema_decay=args.model_ema_decay)
    ens_state = TrainState.create(ens, make_optimizer(ens_cfg, steps_per_epoch),
                                  use_ema=args.model_ema, ema_decay=args.model_ema_decay)

    aug_cfg = C.augment_config_from_args(args, args.input_size, train_ds.images.shape[1])
    mix_cfg = C.mixup_config_from_args(args, num_classes)
    prep_train, host_tf = C.make_train_pipeline(args, aug_cfg, dtype, device)
    prep_eval = C.make_eval_prepare(args.input_size, dtype, device)
    cct = isinstance(backbone, CCT)
    make_train = S.make_cct_ensemble_train_step if cct else S.make_ensemble_train_step
    step = make_train(
        backbone, ens, teacher, mixup=mix_cfg, smoothing=args.smoothing,
        distillation_type=args.distillation_type, distillation_alpha=args.distillation_alpha,
        distillation_tau=args.distillation_tau, layout=layout)
    ens_eval = (S.make_cct_ensemble_eval_step if cct else S.make_ensemble_eval_step)(
        backbone, ens, layout)

    # every rank restores the whole checkpoint, then keeps its divisions
    bb_state, ens_state, start_epoch = _try_resume_ensemble(args, bb_state, ens_state, log)
    all_gates = gates
    if layout is not None:
        M.shard_state(bb_state, layout)
        if gates is not None:
            gates = Gates(**M.shard_division_tree(gates._asdict(), layout))

    def step_fn(carry, images, labels, generator):
        bb_state, ens_state = carry
        x = prep_train(generator, images)
        bb_state, ens_state, metrics = step(bb_state, ens_state, None, gates, x,
                                            C.batch_to(labels, device), generator)
        return (bb_state, ens_state), metrics

    def eval_fn(carry):
        bb_state, _ = carry
        return run_eval(lambda _, g, im, lb: ens_eval(bb_state.params, None, g, im, lb), None,
                        gates, _val_batches(args, val_ds), prepare=prep_eval)

    save = C.make_saver(args)

    def save_state(path, carry, epoch):
        # gathered over the division group: the file is one process's
        bb_state, ens_state = carry
        if layout is not None:
            bb_state = M.gathered_state(bb_state, layout)
        save(path, stage5_tree(bb_state, ens_state, epoch, all_gates))

    if args.eval:
        m = eval_fn((bb_state, ens_state))
        log.info(f"{label} eval: acc1 {m['acc1']:.2f}")
        return m["acc1"]

    _, best = fit(
        carry=(bb_state, ens_state), step_fn=step_fn,
        train_batches_fn=_train_batches(args, train_ds, host_tf), eval_fn=eval_fn,
        epochs=args.epochs, generator=torch.Generator().manual_seed(args.seed + 2),
        output_dir=args.output_dir, log_fn=log.info, save_state_fn=save_state,
        profile_dir=getattr(args, "profile_dir", None),
        tensorboard=getattr(args, "tensorboard", False), start_epoch=start_epoch)
    log.info(f"{label} best acc1: {best:.2f}")
    C.barrier()
    return best


def _division_checkpoint(root: str, i: int) -> str:
    p = os.path.join(root, f"sub-dataset{i}", "checkpoint.msgpack")
    pth = os.path.join(root, f"sub-dataset{i}", "checkpoint.pth")
    return pth if not os.path.exists(p) and os.path.exists(pth) else p


def ensemble_main(args) -> float:
    """Stage 5: token-fusion ensemble over D backbones (ensemble.py:245-456).
    Sub-model checkpoints load by name into the stacked parameters (the
    classifier heads they carry are dropped). The CCT family (MultiCCT +
    EnsembleCCT, ensemble_models.py:93-151) runs the headless 'decct'
    backbone of --model and its own fusion head and steps."""
    log = C.setup(args)
    device = C.device_from_args(args)
    cat = getattr(args, "inat_category", "name")
    train_ds = build_dataset(args.dataset, args.data_path, train=True,
                             img_size=args.input_size, inat_category=cat)
    val_ds = build_dataset(args.dataset, args.data_path, train=False,
                           img_size=args.input_size, inat_category=cat)
    num_classes = train_ds.num_classes
    D = args.num_division
    # no manifest: stage 5 trains the fusion over the full label set
    # (ensemble.py:261); divisions enter through their checkpoints and gates
    if args.compact_path:
        return _ensemble_eval_compact(args, log, val_ds, num_classes, D)
    cct = C.is_cct(args.model)
    name = ("de" + args.model if cct and not args.model.startswith("decct") else args.model)
    backbone = C.build_model(name, 0, args)  # features only: heads never used
    names = features_param_names(backbone)

    ckpt_gates = []
    if args.sub_model_path:
        template = C.model_tree(backbone, names)
        div_params = []
        for i in range(D):
            p = _division_checkpoint(args.sub_model_path, i)
            if p.endswith((".pth", ".pt")):
                # .pth carries no gates: the gap keeps the all(...) guard below
                params, gates_i = C.read_params(p, backbone.cfg), None
            else:
                # one restore feeds the by-name merge and the gates
                raw = restore_pytree(p)
                params = raw.get("params", raw) if isinstance(raw, dict) else raw
                gates_i = raw.get("gates") if isinstance(raw, dict) else None
            merged = C.merge_params_into(backbone, params, template, log=log)
            vals = vit_values_from_jax_params(merged, names)
            div_params.append({k: torch.from_numpy(np.ascontiguousarray(vals[k])).to(device)
                               for k in names})
            ckpt_gates.append(gates_i)
        stacked = stack_division_params(div_params)
    else:
        stacked = init_multivit(backbone, [torch.Generator().manual_seed(args.seed + i)
                                           for i in range(D)])

    gates = None
    if args.gates_path:
        gates = stack_division_gates([
            Gates(*(torch.as_tensor(np.asarray(g[k], np.float32)) for k in ("head", "neuron")))
            for g in (restore_pytree(os.path.join(args.gates_path, f"sub-dataset{i}",
                                                  "gates.msgpack")) for i in range(D))])
    elif ckpt_gates and all(g is not None for g in ckpt_gates):
        # the distill checkpoints carry their shrink gates: train the fusion
        # on the same gated features the deployed artifacts serve (the
        # reference drops them, a resolved bug, SURVEY.md section 7)
        gates = stack_division_gates([
            Gates(*(torch.as_tensor(np.asarray(g[k], np.float32)) for k in ("head", "neuron")))
            for g in ckpt_gates])
        log.info("applied shrink gates from the distill checkpoints")
    if gates is not None:
        gates = Gates(gates.head.to(device), gates.neuron.to(device))

    if cct:
        ens = EnsembleCCT(num_classes=num_classes, sub_size=backbone.cfg.embed_dim,
                          num_divisions=D, teacher_size=args.teacher_size)
    else:
        ens = EnsMLP(num_classes=num_classes, sub_size=backbone.cfg.embed_dim, num_divisions=D,
                     teacher_size=args.teacher_size,
                     family="deit" if backbone.cfg.distilled else "vit")
    ens = ens.reset_parameters(torch.Generator().manual_seed(args.seed + 1)).to(device)

    teacher = None
    if args.distillation_type != "none":
        if not args.teacher_path:
            raise ValueError(f"--distillation-type {args.distillation_type} requires "
                             "--teacher-path (the stage-5 EnsLoss matches the global "
                             "teacher's tokens/logits, ensemble.py:359-361)")
        teacher = C.build_model(args.teacher_model, num_classes, args)
        C.load_params_for(teacher, args.teacher_path, log)

    return _run_ensemble_training(args, log, train_ds, val_ds, num_classes, D, backbone,
                                  stacked, ens, teacher, gates,
                                  label="CCT ensemble" if cct else "ensemble")


# ------------------------------------------------------------------ pipeline


PIPELINE_STAGES = ["split", "train_sub", "shrink", "distill", "ensemble", "deploy"]


def pipeline_main(args):
    """One-shot orchestrator: split -> per division (train_sub -> shrink ->
    distill) -> ensemble -> deploy under one output root (the reference's
    five manual commands, README.md:40-69, plus deploy). A stage whose final
    artifact exists is skipped (delete its directory or pass --force), so an
    interrupted pipeline resumes at the stage boundary; within a stage the
    per-epoch checkpoint_temp resumes it.

    Layout under --output_dir:
      division{D}/manifest.json   sub-model{i}/   shrink{i}/
      sub-dataset{i}/ (distilled) ensemble/       deploy/
    """
    log = C.setup(args)
    root = args.output_dir
    selected = [s.strip() for s in args.stages.split(",") if s.strip()]
    bad = [s for s in selected if s not in PIPELINE_STAGES]
    if bad:
        raise ValueError(f"unknown pipeline stage(s) {bad}; choose from {PIPELINE_STAGES}")

    # --lr/--weight-decay default to None here so an explicit value is
    # distinguishable from unset: stages 2-4 take the generic defaults, the
    # ensemble its own recipe (ensemble.py lr 1e-5 / wd 0.05) only when unset
    shared_lr, shared_wd = args.lr, args.weight_decay
    base_optim = {"lr": shared_lr if shared_lr is not None else 5e-4,
                  "weight_decay": shared_wd if shared_wd is not None else 0.0}

    def ns(**overrides):
        d = {k: v for k, v in vars(args).items() if k not in ("fn", "stages", "force")}
        d.update(base_optim)
        d.update(overrides)
        return argparse.Namespace(**d)

    def stage_resume(stage_dir):
        """Intra-stage resume: a killed stage leaves checkpoint_temp.msgpack.
        --force retrains from scratch (a completed stage's checkpoint_temp
        would resume at epochs and train nothing)."""
        if args.force:
            return ""
        ptmp = os.path.join(stage_dir, "checkpoint_temp.msgpack")
        if os.path.exists(ptmp):
            log.info(f"pipeline: resuming interrupted stage from {ptmp}")
            return ptmp
        return ""

    def done(*path):
        return not args.force and os.path.exists(os.path.join(root, *path))

    manifest = os.path.join(root, f"division{args.num_division}", "manifest.json")
    results = {}
    if "split" in selected:
        if done(f"division{args.num_division}", "manifest.json"):
            log.info("pipeline: split artifact exists - skipping")
        else:
            split_main(ns(output_dir=root))

    for d in range(args.num_division):
        sub = os.path.join(root, f"sub-model{d}")
        if "train_sub" in selected:
            if done(f"sub-model{d}", "checkpoint.msgpack"):
                log.info(f"pipeline: stage-2 division {d} exists - skipping")
            else:
                results[f"train_sub{d}"] = train_sub_main(
                    ns(start_division=d, output_dir=sub, manifest=manifest,
                       resume=stage_resume(sub)))
        shrink_dir = os.path.join(root, f"shrink{d}")
        ckpt = os.path.join(sub, "checkpoint.msgpack")
        if "shrink" in selected:
            if done(f"shrink{d}", "shrinked_policy.npy"):
                log.info(f"pipeline: shrink division {d} exists - skipping")
            else:
                shrink_main(ns(start_division=d, output_dir=shrink_dir, manifest=manifest,
                               model_path=ckpt, resume=""))
        if "distill" in selected:
            if done(f"sub-dataset{d}", "checkpoint.msgpack"):
                log.info(f"pipeline: distill division {d} exists - skipping")
            else:
                # DEKD needs a real teacher. --teacher-path is a root of
                # per-division teachers (sub-dataset{i}, then sub-model{i},
                # then the literal file); without it the division
                # self-distills from its own stage-2 checkpoint
                if args.teacher_path:
                    t_model = args.teacher_model
                    cands = [os.path.join(args.teacher_path, f"sub-dataset{d}",
                                          "checkpoint.msgpack"),
                             os.path.join(args.teacher_path, f"sub-model{d}",
                                          "checkpoint.msgpack"),
                             args.teacher_path]
                    t_path = next((c for c in cands if os.path.exists(c)), cands[-1])
                else:
                    t_model, t_path = args.model, ckpt
                    log.info(f"pipeline: no --teacher-path - division {d} self-distills from "
                             f"its stage-2 checkpoint ({args.model} as its own teacher)")
                # DEKD always distills (distill_sub defaults: hard + clip 1.0)
                dist_dir = os.path.join(root, f"sub-dataset{d}")
                results[f"distill{d}"] = distill_main(
                    ns(start_division=d, output_dir=dist_dir, manifest=manifest,
                       model_path=ckpt, policy_path=shrink_dir,
                       resume=stage_resume(dist_dir), teacher_model=t_model,
                       teacher_path=t_path,
                       distillation_type=(args.distillation_type
                                          if args.distillation_type != "none" else "hard"),
                       clip_grad=args.clip_grad if args.clip_grad is not None else 1.0))

    if "ensemble" in selected:
        if done("ensemble", "checkpoint.msgpack"):
            log.info("pipeline: ensemble exists - skipping")
        else:
            # the ensemble subcommand's reference recipe (lr 1e-5, weight
            # decay 0.05) unless the shared flag or the stage-5 override was
            # set explicitly
            ens_overrides = {}
            if getattr(args, "ens_backbone_lr", None) is not None:
                ens_overrides["lr"] = args.ens_backbone_lr
            elif shared_lr is None:
                ens_overrides["lr"] = 1e-5
            if getattr(args, "ens_weight_decay", None) is not None:
                ens_overrides["weight_decay"] = args.ens_weight_decay
            elif shared_wd is None:
                ens_overrides["weight_decay"] = 0.05
            ens_dir = os.path.join(root, "ensemble")
            results["ensemble"] = ensemble_main(
                ns(output_dir=ens_dir, sub_model_path=root, manifest=manifest,
                   resume=stage_resume(ens_dir), compact_path=None, ens_path=None,
                   gates_path=None, **ens_overrides))
    if "deploy" in selected and C.is_cct(args.model):
        # ragged compaction (models/compact_vit.py) is ViT-family only; CCT
        # divisions serve through the gated stacked path
        log.info("pipeline: deploy (ragged compaction) is ViT-only — "
                 "skipping for the CCT family")
    elif "deploy" in selected:
        if done("deploy", "deploy_report.json"):
            log.info("pipeline: deploy artifacts exist - skipping")
        else:
            # deploy the stage-5 backbones when they exist (what serves);
            # else the distill checkpoints
            ens_ckpt = os.path.join(root, "ensemble", "checkpoint.msgpack")
            if not os.path.exists(ens_ckpt):
                log.info("pipeline: no ensemble checkpoint - deploying from the distill "
                         "checkpoints")
                ens_ckpt = None
            deploy_main(ns(output_dir=os.path.join(root, "deploy"), ensemble_path=ens_ckpt,
                           sub_model_path=root, deploy_num_classes=args.deploy_num_classes))
    log.info(f"pipeline complete: {sorted(results)}")
    return results


# ------------------------------------------------------------------ deploy


def _deploy_division_sources(args, cfg, log):
    """Yield (division, flax params, gates) to compact: from the stage-5
    checkpoint (--ensemble-path: the backbones as the fusion stage trained
    them, with its stacked gates) or the per-division distill checkpoints
    (--sub-model-path)."""
    if getattr(args, "ensemble_path", None):
        ckpt = restore_pytree(args.ensemble_path)
        stacked = ckpt["backbone_params"]
        g = ckpt.get("gates")
        # the checkpoint's stacked axis is authoritative for D
        ckpt_D = int(np.asarray(stacked["pos_embed"]).shape[0])
        if ckpt_D != args.num_division:
            log.info(f"NOTE: checkpoint has {ckpt_D} divisions; deploying all of them "
                     f"(--num_division {args.num_division} ignored)")
        log.info(f"deploying ensemble-trained backbones from {args.ensemble_path}"
                 + ("" if g is not None else " (ungated)"))
        for i in range(ckpt_D):
            params = map_leaves(lambda a: np.asarray(a)[i], stacked)
            gates = (Gates(np.asarray(g["head"])[i], np.asarray(g["neuron"])[i])
                     if g is not None else full_gates(cfg).numpy())
            yield i, params, gates
        return
    if not args.sub_model_path:
        raise ValueError("deploy needs --sub-model-path (distill checkpoints) or "
                         "--ensemble-path (stage-5 checkpoint)")
    for i in range(args.num_division):
        ckpt = restore_pytree(os.path.join(args.sub_model_path, f"sub-dataset{i}",
                                           "checkpoint.msgpack"))
        # the live params: the reference deploys the live model, never the EMA
        params = ckpt.get("params", ckpt)
        g = ckpt.get("gates")
        gates = (Gates(np.asarray(g["head"]), np.asarray(g["neuron"])) if g is not None
                 else full_gates(cfg).numpy())
        yield i, params, gates


def deploy_main(args):
    """The serving artifacts: each division's checkpoint ragged-compacted
    (sub-dataset{i}/compact.msgpack) and an analytic MACs report
    (deploy_report.json)."""
    from devit_tpu_torch.core.metrics import cal_shrink_macs, cal_shrink_paras
    from devit_tpu_torch.core.rank import check_sparsity
    from devit_tpu_torch.models.compact_vit import compact_vit_ragged, save_compact

    log = C.setup(args)
    cfg = C.model_config(args.model, args.deploy_num_classes, args)
    report = []
    for i, params, gates in _deploy_division_sources(args, cfg, log):
        params = map_leaves(
            lambda a: np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32),
            params)
        cm = compact_vit_ragged(params, gates, cfg, neuron_multiple=args.neuron_multiple,
                                device="cpu")
        out = os.path.join(args.output_dir, f"sub-dataset{i}", "compact.msgpack")
        if is_main_process():
            save_compact(out, cm)
        n_sp, h_sp = check_sparsity(gates)
        # 197 for the canonical dedeit geometry only (shrink_imp.py:75)
        canonical = cfg.depth == 12 and cfg.embed_dim == 384 and cfg.num_heads == 6
        seq_length = 197 if canonical else cfg.seq_len
        kw = dict(emb=cfg.embed_dim, seq_length=seq_length, mlp_ratio=cfg.mlp_ratio,
                  head=cfg.num_heads, layer=cfg.depth)
        macs = cal_shrink_macs(list(n_sp), list(h_sp), **kw)
        paras = cal_shrink_paras(list(n_sp), list(h_sp), **kw)
        kept_h = sum(cm.num_heads)
        log.info(f"division {i}: {macs:.3f} GMACs, {paras:.1f} M params, "
                 f"{kept_h}/{cfg.depth * cfg.num_heads} heads -> {out}")
        report.append({"division": i, "gmacs": macs, "mparams": paras})
    if is_main_process():
        with open(os.path.join(args.output_dir, "deploy_report.json"), "w") as f:
            json.dump(report, f, indent=1)
    C.barrier()
    return report


# ------------------------------------------------------------------ convert


def convert_main(args):
    """Standalone checkpoint conversion (docs/MIGRATION.md "Checkpoint
    compatibility"): in .pth/.pt (reference-layout ViT state dict), .npz
    (Flax ViT), .msgpack (ours); out .msgpack (the full tree) or .pth/.pt
    (ViT family: the reference layout). Geometry (depth, a CCT's conv
    stages) is read from the file. --ema exports the EMA parameters. Orbax
    directories raise (not ported)."""
    from devit_tpu_torch.io.checkpoint import (
        load_flax_npz_vit, load_torch_state_dict, params_to_torch_vit, save_pytree,
        torch_cct_to_params, torch_vit_to_params,
    )

    src, dst = args.src, args.dst
    if src.endswith((".pth", ".pt")):
        sd = load_torch_state_dict(src)
        if any(k.startswith("classifier.blocks.") for k in sd):
            L = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("classifier.blocks."))
            nconv = 1 + max(int(k.split(".")[2]) for k in sd
                            if k.startswith("tokenizer.conv_layers."))
            tree = {"params": torch_cct_to_params(sd, num_layers=L, n_conv_layers=nconv)}
        elif any(k.startswith("blocks.") for k in sd):
            L = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
            tree = {"params": torch_vit_to_params(sd, depth=L)}
        else:
            raise ValueError(f"{src}: no blocks.* / classifier.blocks.* keys - not a "
                             "reference-layout ViT/CCT state dict")
    elif src.endswith(".npz"):
        w = np.load(src)
        L = 1 + max(int(k.split("encoderblock_")[1].split("/")[0])
                    for k in w.files if "encoderblock_" in k)
        tree = {"params": load_flax_npz_vit(src, depth=L)}
    else:
        tree = restore_pytree(src)
        if not (isinstance(tree, dict) and "params" in tree):
            tree = {"params": tree}

    params = tree["params"]
    if args.ema:
        if tree.get("ema_params") is None:
            raise ValueError(f"--ema: no ema_params in {src}")
        params = tree["ema_params"]

    if dst.endswith((".pth", ".pt")):
        if not (isinstance(params, dict) and "qkv" in params.get("blocks", {})):
            raise ValueError("torch export is ViT-family only (params_to_torch_vit)")
        np_params = map_leaves(
            lambda a: np.asarray(a.float() if isinstance(a, torch.Tensor) else a), params)
        depth = int(np.asarray(np_params["blocks"]["qkv"]["kernel"]).shape[0])
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in params_to_torch_vit(np_params, depth).items()}, dst)
        if "gates" in tree:
            print("note: shrink gates are not representable in the torch state dict (the "
                  "reference keeps them non-persistent); apply them there via "
                  "core/imp_rank masks")
    elif dst.endswith(".orbax"):
        raise ValueError(f"{dst}: orbax checkpoints are not ported; write .msgpack")
    elif dst.endswith(".msgpack"):
        save_pytree(dst, dict(tree, params=params) if args.ema else tree)
    else:
        raise ValueError(f"{dst}: expected .msgpack, .pth or .pt")
    n = sum(int(np.prod(np.shape(x))) for x in C.tree_leaves(params))
    print(f"converted {src} -> {dst} ({n / 1e6:.2f}M params{', ema' if args.ema else ''})")
    return dst


# ------------------------------------------------------------------ ingest


def ingest_main(args):
    """Pre-build the decoded dataset cache (train + val) so the first
    training run does not pay the one-time decode."""
    import time

    for train in (True, False):
        t0 = time.time()
        ds = build_dataset(args.dataset, args.data_path, train, img_size=args.input_size,
                           inat_category=getattr(args, "inat_category", "name"))
        kind = type(ds.images).__name__
        print(f"{args.dataset} {'train' if train else 'val'}: {len(ds)} images, "
              f"{ds.num_classes} classes, cache={kind} ({time.time() - t0:.1f}s)")
    return 0
