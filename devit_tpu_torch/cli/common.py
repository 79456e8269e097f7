"""Shared CLI plumbing (counterpart of devit_tpu/cli/common.py): the same
argparse groups, flag names and defaults as the JAX CLI (the reference's
~80 flags, kept name-compatible), the config builders, the dataset and
model builders, checkpoint loading by name, and the train/eval transforms.

One flag is the port's own: `--device {cuda,cpu}` (default cuda) on every
subcommand. cuda without a card raises; nothing falls back to the CPU.

Under several processes (`torchrun --nproc-per-node N -m
devit_tpu_torch.cli ...`, or the DEVIT_COORDINATOR variables;
runtime.setup_runtime) each rank runs on its own card, and
parallel_context gives the stages the layout the JAX CLI's placers give
its meshes: the batch sharded over the
'data' ranks, stage 5's divisions over the 'div' ranks. Rank 0 alone writes
files.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from devit_tpu_torch.configs import CCTConfig, get_cct_config, get_vit_config
from devit_tpu_torch.data.datasets import ArrayDataset, BatchIterator, build_dataset
from devit_tpu_torch.data.mixup import MixupConfig
from devit_tpu_torch.data.pipeline import (
    AugmentConfig, eval_transform, finish_transform, train_transform,
)
from devit_tpu_torch.data.splitter import DivisionManifest
from devit_tpu_torch.device import resolve_device
from devit_tpu_torch.io.bridge import vit_to_jax_params, vit_values_from_jax_params
from devit_tpu_torch.io.checkpoint import (
    load_torch_state_dict, resize_cct_pos_embed, resize_pos_embed, restore_pytree, save_pytree,
    torch_cct_to_params, torch_vit_to_params,
)
from devit_tpu_torch.models.cct import CCT
from devit_tpu_torch.models.vit import VisionTransformer
from devit_tpu_torch.train.meters import create_logger
from devit_tpu_torch.train.optim import OptimConfig

def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the port runs: cuda (default; raises without a card) or "
                        "cpu (the plain PyTorch versions of the kernels)")


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="deit_base_distilled_patch16_224", type=str)
    p.add_argument("--model-path", type=str, default=None,
                   help="pretrained checkpoint (.pth or .msgpack)")
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--patch-size", default=16, type=int)
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--drop-path", type=float, default=0.1)
    p.add_argument("--model-ema", action="store_true", default=True)
    p.add_argument("--no-model-ema", action="store_false", dest="model_ema")
    p.add_argument("--model-ema-decay", type=float, default=0.99996)
    # geometry overrides (None = registry defaults) - used by smoke tests
    p.add_argument("--embed-dim", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--num-heads", type=int, default=None)
    # the JAX CLI's names; here they choose the CUDA kernels (None: on cuda)
    p.add_argument("--use-pallas", dest="use_pallas", action="store_true", default=None)
    p.add_argument("--no-pallas", dest="use_pallas", action="store_false")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                   help="compute dtype for models and the data pipeline (bfloat16 the "
                        "production setting; float32 for numerics checks and CPU parity)")


def add_optim_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch-size", default=64, type=int)
    p.add_argument("--eval-batch-size", default=512, type=int)  # reference default
    p.add_argument("--epochs", default=5, type=int)
    p.add_argument("--opt", default="adamw", type=str,
                   help="adamw|adam|sgd|nesterov|momentum (timm create_optimizer "
                        "names, train_subdata.py:61; others rejected loudly)")
    p.add_argument("--opt-betas", default=None, type=float, nargs="+",
                   help="optimizer betas override (reference default: None)")
    p.add_argument("--momentum", type=float, default=0.9,
                   help="SGD momentum (train_subdata.py:69)")
    p.add_argument("--opt-eps", default=1e-8, type=float)
    p.add_argument("--clip-grad", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--min-lr", type=float, default=1e-5)
    p.add_argument("--sched", default="cosine", type=str,
                   help="cosine|step|constant (timm create_scheduler names, "
                        "train_subdata.py:74; others rejected loudly)")
    p.add_argument("--decay-epochs", type=float, default=30,
                   help="epoch interval for --sched step (train_subdata.py:89)")
    p.add_argument("--decay-rate", "--dr", type=float, default=0.1, dest="decay_rate",
                   help="LR decay rate for --sched step (train_subdata.py:98)")
    p.add_argument("--lr-noise", type=float, nargs="+", default=None,
                   help="LR noise on/off epoch percentages (timm; requires "
                        "--sched-per-epoch, where it is bit-exact)")
    p.add_argument("--lr-noise-pct", type=float, default=0.67)
    p.add_argument("--lr-noise-std", type=float, default=1.0,
                   help="accepted-and-inert, exactly as in timm-0.5.4 "
                        "(its _add_noise never uses noise_std)")
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--cooldown-epochs", type=int, default=10)
    p.add_argument("--scale-lr", action="store_true", default=True,
                   help="linear scale lr by global_batch/512 (train_subdata.py:405)")
    p.add_argument("--no-scale-lr", action="store_false", dest="scale_lr")
    p.add_argument("--sched-per-epoch", action="store_true",
                   help="bit-parity LR mode: the reference's per-epoch timm staircase incl. "
                        "its one-epoch step(epoch) lag (train_subdata.py:449) instead of the "
                        "smooth per-step cosine")


def add_aug_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--color-jitter", type=float, default=0.4)
    p.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    p.add_argument("--no-aug", action="store_true")
    p.add_argument("--train-interpolation", type=str, default="bicubic",
                   choices=["bicubic", "bilinear", "random"],
                   help="RRC resample filter (train_subdata.py:107)")
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--repeated-aug", action="store_true", default=True)
    p.add_argument("--no-repeated-aug", action="store_false", dest="repeated_aug")
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--remode", type=str, default="pixel", choices=["pixel", "rand", "const"],
                   help="random-erasing fill (train_subdata.py:117)")
    p.add_argument("--recount", type=int, default=1,
                   help="random-erasing max box count (train_subdata.py:119)")
    p.add_argument("--aug-backend", choices=["auto", "host", "device"], default="auto",
                   help="where train augmentation runs: host = PIL in the prefetch thread "
                        "(auto picks this for RandAugment training), device = the tensor "
                        "pipeline on the device")
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--cutmix-minmax", type=float, nargs="+", default=None,
                   help="cutmix min/max box-side ratio; overrides the Beta box and forces "
                        "cutmix on (timm, train_subdata.py:129)")
    p.add_argument("--mixup-prob", type=float, default=1.0)
    p.add_argument("--mixup-switch-prob", type=float, default=0.5)
    p.add_argument("--mixup-mode", choices=["batch", "pair", "elem"], default="batch",
                   help="timm Mixup mode (train_subdata.py:135)")


def add_distill_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--teacher-model", default="deit_base_distilled_patch16_224", type=str)
    p.add_argument("--teacher-path", type=str, default=None)
    p.add_argument("--distillation-type", default="none", choices=["none", "soft", "hard"])
    p.add_argument("--distillation-token", action="store_true")
    p.add_argument("--distillation-alpha", default=0.5, type=float)
    p.add_argument("--distillation-tau", default=1.0, type=float)


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-path", default="./datasets", type=str)
    p.add_argument("--dataset", "--data-set", dest="dataset", default="cifar100", type=str,
                   help="cifar100|cifar10|IMNET|INAT|INAT19|flowers|cars|pets|"
                        "synthetic[:K[:N[:S]]] (--data-set accepted for reference flag-name "
                        "compatibility)")
    p.add_argument("--inat-category", default="name",
                   choices=["kingdom", "phylum", "class", "order", "supercategory", "family",
                            "genus", "name"],
                   help="iNaturalist taxonomic label rank (train_subdata.py:162)")
    p.add_argument("--num_division", default=4, type=int)
    p.add_argument("--start-division", default=0, type=int)
    p.add_argument("--manifest", type=str, default=None,
                   help="manifest.json from the split stage")
    p.add_argument("--output_dir", default="./output", type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of the first trained epoch")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard scalars to output_dir (reference tags "
                        "Train/*, Test/Top1|Top5|loss, train_subdata.py:437-472); the JSONL "
                        "artifacts are always written")
    p.add_argument("--ckpt-format", choices=["msgpack", "orbax"], default="msgpack",
                   help="msgpack (one file, written atomically) or orbax (a checkpoint "
                        "directory '.orbax', written in the background; the JAX package's "
                        "orbax format)")


def parse_ra_string(aa: Optional[str]) -> Tuple[bool, int, float, int, bool, bool]:
    """'rand-m9-n2-mstd0.5-inc1[-w0]' -> (enabled, magnitude, mag_std, num_ops,
    inc, weighted): the timm-0.5.4 RandAugment recipe grammar, with its
    rejections (wN for N != 0, w0 with inc1, timm>=0.6's mmaxN and pP)."""
    if not aa or not aa.startswith("rand"):
        return False, 9, 0.5, 2, True, False
    mag, std, num_ops, inc, weighted = 9, 0.5, 2, False, False
    for part in aa.split("-")[1:]:
        if part.startswith("mstd"):
            std = float(part[4:])
        elif part.startswith("mmax") or part.startswith("p"):
            raise ValueError(
                f"--aa component {part!r} is timm>=0.6 only (the pinned 0.5.4 grammar has no "
                "mmax/p); remove it from the recipe")
        elif part.startswith("w"):
            if part != "w0":
                raise ValueError(
                    f"--aa component {part!r}: timm-0.5.4 has exactly one weight set "
                    "(_select_rand_weights asserts weight_idx==0) - use w0")
            weighted = True
        elif part.startswith("m") and part[1:].isdigit():
            mag = int(part[1:])
        elif part.startswith("n") and part[1:].isdigit():
            num_ops = int(part[1:])
        elif part.startswith("inc"):
            inc = bool(int(part[3:]))
        elif part:
            raise ValueError(f"unrecognized --aa component {part!r}")
    if weighted and inc:
        raise ValueError(f"--aa {aa!r}: w0 together with inc1 crashes timm-0.5.4 "
                         "(_RAND_CHOICE_WEIGHTS_0 has no *Increasing keys) - drop one")
    return True, mag, std, num_ops, inc, weighted


def dtype_from_args(args) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        getattr(args, "dtype", "bfloat16")]


def device_from_args(args) -> torch.device:
    return resolve_device(getattr(args, "device", "cuda"))


def augment_config_from_args(args, img_size: int, source_size: int) -> AugmentConfig:
    aa = getattr(args, "aa", None)
    ra, mag, std, num_ops, ra_inc, ra_weighted = parse_ra_string(aa)
    # '--aa original' / '--aa cifar10': the reference's AutoAugment policies
    autoaug = aa if aa in ("original", "cifar10") else None
    if aa and not ra and autoaug is None:
        raise ValueError(
            f"unrecognized --aa {aa!r}: expected a 'rand-*' RandAugment recipe, "
            "'original'/'cifar10' (the AutoAugment policies in the reference's "
            "utils/autoaug.py), or '' to disable")
    reprob = args.reprob
    no_aug = bool(getattr(args, "no_aug", False))
    if no_aug:
        # timm transforms_noaug_train: resize + center crop + normalize;
        # auto-augment and random erasing off
        ra, autoaug, reprob = False, None, 0.0
    return AugmentConfig(
        img_size=img_size, no_aug=no_aug, color_jitter=args.color_jitter, reprob=reprob,
        re_mode=getattr(args, "remode", "pixel"), re_count=getattr(args, "recount", 1),
        interpolation=getattr(args, "train_interpolation", "bicubic"), randaugment=ra,
        ra_magnitude=mag, ra_std=std, ra_num_ops=num_ops, ra_inc=ra_inc,
        ra_weighted=ra_weighted, autoaugment=autoaug,
        small_image=img_size == source_size and source_size <= 64)


def mixup_config_from_args(args, num_classes: int) -> Optional[MixupConfig]:
    minmax = getattr(args, "cutmix_minmax", None)
    if minmax is not None and len(minmax) != 2:
        raise ValueError("--cutmix-minmax takes exactly two floats (timm asserts len==2)")
    # reference activation test: mixup > 0 or cutmix > 0 or cutmix_minmax set
    if args.mixup <= 0 and args.cutmix <= 0 and minmax is None:
        return None
    return MixupConfig(
        mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
        cutmix_minmax=tuple(minmax) if minmax is not None else None,
        prob=args.mixup_prob, switch_prob=args.mixup_switch_prob,
        mode=getattr(args, "mixup_mode", "batch"), label_smoothing=args.smoothing,
        num_classes=num_classes)


def optim_config_from_args(args, global_batch: int) -> OptimConfig:
    betas = getattr(args, "opt_betas", None)
    if betas is not None and len(betas) != 2:
        raise ValueError(f"--opt-betas expects two values, got {betas}")
    cfg = OptimConfig(
        lr=args.lr, min_lr=args.min_lr, warmup_lr=args.warmup_lr,
        warmup_epochs=args.warmup_epochs, cooldown_epochs=args.cooldown_epochs,
        epochs=args.epochs, weight_decay=args.weight_decay, opt_eps=args.opt_eps,
        clip_grad=args.clip_grad, scale_lr_by_batch=args.scale_lr, global_batch=global_batch,
        sched_per_epoch=getattr(args, "sched_per_epoch", False),
        opt=getattr(args, "opt", "adamw"), momentum=getattr(args, "momentum", 0.9),
        sched=getattr(args, "sched", "cosine"), decay_epochs=getattr(args, "decay_epochs", 30.0),
        decay_rate=getattr(args, "decay_rate", 0.1),
        lr_noise=tuple(args.lr_noise) if getattr(args, "lr_noise", None) else None,
        lr_noise_pct=getattr(args, "lr_noise_pct", 0.67),
        lr_noise_std=getattr(args, "lr_noise_std", 1.0), seed=getattr(args, "seed", 42))
    if betas is not None:
        cfg.beta1, cfg.beta2 = float(betas[0]), float(betas[1])
    return cfg


def build_division_data(args) -> Tuple[ArrayDataset, ArrayDataset, DivisionManifest]:
    """Full train/val sets + manifest; callers take division views."""
    cat = getattr(args, "inat_category", "name")
    train_ds = build_dataset(args.dataset, args.data_path, train=True,
                             img_size=args.input_size, inat_category=cat)
    val_ds = build_dataset(args.dataset, args.data_path, train=False,
                           img_size=args.input_size, inat_category=cat)
    if args.manifest:
        if not os.path.exists(args.manifest):
            # a typo'd path must not silently train on a regenerated split
            raise FileNotFoundError(f"--manifest {args.manifest} does not exist")
        manifest = DivisionManifest.load(args.manifest)
    else:
        manifest = DivisionManifest.create(train_ds.num_classes, args.num_division, seed=42)
    return train_ds, val_ds, manifest


def is_cct(name: str) -> bool:
    return name.startswith("cct") or name.startswith("decct")


def model_seq_length(cfg) -> int:
    """The true token count of a model config, for the analytic MACs and
    params budget: a CCT's from its tokenizer geometry
    (CCTConfig.sequence_length), a ViT's patches plus prefix tokens."""
    if isinstance(cfg, CCTConfig):
        return int(cfg.sequence_length())
    return int(cfg.seq_len)


def model_config(name: str, num_classes: int, args, resize_dim=None):
    """The registered geometry with the CLI's overrides (a CCT's 'decct_*'
    name is the headless backbone)."""
    if is_cct(name):
        overrides = dict(img_size=args.input_size, num_classes=num_classes, dropout=args.drop,
                         stochastic_depth=args.drop_path, resize_dim=resize_dim)
        for flag, key in (("embed_dim", "embed_dim"), ("depth", "num_layers"),
                          ("num_heads", "num_heads")):
            v = getattr(args, flag, None)
            if v is not None:
                overrides[key] = v
        if name.startswith("decct"):
            overrides.setdefault("backbone", True)
            name = name.replace("decct", "cct", 1)
        return get_cct_config(name, **overrides)
    overrides = dict(img_size=args.input_size, patch_size=getattr(args, "patch_size", 16),
                     num_classes=num_classes, drop_rate=args.drop,
                     drop_path_rate=args.drop_path, resize_dim=resize_dim)
    for flag in ("embed_dim", "depth", "num_heads"):
        v = getattr(args, flag, None)
        if v is not None:
            overrides[flag] = v
    return get_vit_config(name, **overrides)


def build_model(name: str, num_classes: int, args, resize_dim=None, seed: int = 0):
    """model_config's model (a VisionTransformer, or a CCT for 'cct_*' and
    'decct_*', the JAX CLI's build_backbone), its parameters drawn from
    `seed` (the JAX CLI draws from jax.random; both CLIs start from a
    checkpoint through --model-path where results must agree), on --device.
    --use-pallas/--no-pallas choose the CUDA kernels; unset, they run on
    cuda (on the CPU the plain attention, as the JAX CLI on the CPU). A CCT
    computes its attention as plain ops, as the JAX package's does."""
    device = device_from_args(args)
    cfg = model_config(name, num_classes, args, resize_dim)
    if isinstance(cfg, CCTConfig):
        model = CCT(cfg, dtype=dtype_from_args(args))
    else:
        use_kernel = getattr(args, "use_pallas", None)
        if use_kernel is None:
            use_kernel = device.type == "cuda"
        model = VisionTransformer(cfg, dtype=dtype_from_args(args), use_kernel=use_kernel)
    return model.reset_parameters(torch.Generator().manual_seed(seed)).to(device)


# Fresh-classifier roots that are EXPECTED to keep their init when loading a
# pretrained backbone (reference shrink.py:298-332 filters exactly the head
# keys). Everything else keeping init is a geometry mismatch.
_HEAD_PARAM_ROOTS = ("head", "head_dist", "fc")


def _is_head_root(root: str) -> bool:
    # the resize heads (resize_mlp / resize_att_mlp / resize_encoder_mlp): a
    # stage-2 checkpoint lacks them when stage 4 builds the student with
    # resize_dim set
    return root in _HEAD_PARAM_ROOTS or root.startswith("resize")


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def _n_params(v) -> int:
    return sum(int(np.size(leaf)) for leaf in tree_leaves(v))


def model_tree(model: VisionTransformer, names=None) -> dict:
    """The model's parameters (or those of `names`) as the flax tree."""
    params = dict(model.named_parameters())
    return vit_to_jax_params({k: params[k] for k in (names or params)})


def load_tree_into(model: VisionTransformer, tree: dict, names=None) -> VisionTransformer:
    """Copy a flax-layout tree into the model's parameters (those of
    `names`, all by default), in place."""
    params = dict(model.named_parameters())
    names = list(names or params)
    vals = vit_values_from_jax_params(tree, names)
    with torch.no_grad():
        for k in names:
            params[k].copy_(torch.from_numpy(np.ascontiguousarray(vals[k])))
    return model


def merge_params_into(model: VisionTransformer, params, template=None, log=None,
                      max_init_fraction: float = 0.25) -> dict:
    """By-name merge of a loaded flax-layout param tree into `template` (the
    model's own tree by default) -> the merged tree (numpy leaves).

    Mismatch handling, as the JAX CLI's (loud):
      * `pos_embed` -> bicubic grid resize (de_vit.py:452-473); a CCT's
        `positional_emb` -> bilinear (helpers.py:26-32 pe_check, no prefix
        token under seq-pool);
      * every other missing/shape-mismatched key keeps its init and is logged;
      * if the kept-init fraction of NON-head parameters exceeds
        `max_init_fraction`, raise: a wrong-geometry checkpoint must not train
        from random weights silently.
    """
    cfg = model.cfg
    if template is None:
        template = model_tree(model)
    if log is None:
        log = logging.getLogger("devit_tpu_torch")
    kept_init = []  # (path, reason, n_params)

    def merge(tpl, new, path):
        out = {}
        for k, v in tpl.items():
            p = f"{path}/{k}" if path else str(k)
            if not isinstance(new, dict) or k not in new:
                out[k] = v  # missing (e.g. fresh head) -> keep init
                kept_init.append((p, "missing from checkpoint", _n_params(v)))
            elif isinstance(v, dict):
                if not isinstance(new[k], dict):
                    out[k] = v
                    kept_init.append((p, "checkpoint has a leaf where the model has a "
                                         "subtree", _n_params(v)))
                else:
                    out[k] = merge(v, new[k], p)
            else:
                nv = np.asarray(new[k].float() if isinstance(new[k], torch.Tensor) else new[k],
                                np.float32)
                if nv.shape != v.shape:
                    rv = None
                    if k in ("pos_embed", "positional_emb"):
                        try:
                            rv = np.asarray(
                                resize_cct_pos_embed(nv, v.shape[1], 0 if cfg.seq_pool else 1)
                                if isinstance(cfg, CCTConfig) else
                                resize_pos_embed(nv, cfg.seq_len, cfg.num_prefix_tokens))
                        except ValueError:
                            rv = None  # non-square grid etc. -> keep init
                        if rv is not None and rv.shape != tuple(v.shape):
                            rv = None
                    if rv is not None:
                        out[k] = rv
                        log.info("checkpoint load: resized %s %s -> %s", p, nv.shape, v.shape)
                    else:
                        out[k] = v
                        kept_init.append((p, f"shape {nv.shape} != model {v.shape}",
                                          int(np.size(v))))
                else:
                    out[k] = nv
        return out

    merged = merge(template, params, "")
    if kept_init:
        for p, reason, _ in kept_init:
            log.info("checkpoint load: kept init for %s (%s)", p, reason)
        non_head = [e for e in kept_init if not _is_head_root(e[0].split("/", 1)[0])]
        non_head_total = sum(_n_params(sub) for k, sub in template.items()
                             if not _is_head_root(str(k)))
        frac = sum(s for _, _, s in non_head) / max(1, non_head_total)
        if frac > max_init_fraction:
            offenders = ", ".join(p for p, _, _ in non_head[:6])
            raise ValueError(
                f"checkpoint/model geometry mismatch: {frac:.0%} of non-head parameters "
                f"would keep their random init (first offenders: {offenders}). Refusing to "
                f"train from effectively random weights - check --model geometry vs the "
                f"checkpoint.")
    return merged


def read_params(path: str, cfg) -> dict:
    """A checkpoint's flax-layout params tree: .pth/.pt (a reference-layout
    torch state dict of cfg's family) or msgpack ({'params': ...} or the
    bare tree)."""
    if path.endswith((".pth", ".pt")):
        sd = load_torch_state_dict(path)
        if isinstance(cfg, CCTConfig):
            return torch_cct_to_params(sd, num_layers=cfg.num_layers,
                                       n_conv_layers=cfg.n_conv_layers)
        return torch_vit_to_params(sd, depth=cfg.depth)
    restored = restore_pytree(path)
    return restored.get("params", restored) if isinstance(restored, dict) else restored


def load_params_for(model: VisionTransformer, path: str, log=None) -> VisionTransformer:
    """Load a .pth or .msgpack checkpoint into the model by name, in place,
    with head-shape filtering and pos-embed interpolation on mismatch
    (shrink.py:298-332 behaviour)."""
    merged = merge_params_into(model, read_params(path, model.cfg), log=log)
    return load_tree_into(model, merged)


def make_saver(args):
    """Stage checkpoint writer honoring --ckpt-format. Off the main process it
    writes nothing (reference save_on_master, dist_utils.py:210-212).
    msgpack: one file. orbax: the '.msgpack' suffix becomes '.orbax' (a
    checkpoint directory), the save is async (fit waits for durability at
    the end of training), and the stage trees' device state is recorded as
    the JAX package's jax.Arrays (train/state.py HOST_ENTRIES). The JAX
    package's orbax save is a collective, every process writing its
    addressable shards, because its trees may be sharded across processes;
    the port's states are replicated (DDP) or gathered before the save
    (parallel/mesh.py gathered_state), so process 0 holds the whole tree
    and writes it alone. The other ranks read it only past the stage's
    closing barrier, which follows fit's wait for durability."""
    from devit_tpu_torch.runtime import is_main_process

    if not is_main_process():
        return lambda path, tree: None
    if getattr(args, "ckpt_format", "msgpack") == "orbax":
        from devit_tpu_torch.io.checkpoint import save_pytree_orbax
        from devit_tpu_torch.train.state import HOST_ENTRIES

        def save(path, tree):
            if path.endswith(".msgpack"):
                path = path[: -len(".msgpack")] + ".orbax"
            save_pytree_orbax(path, tree, device_state=set(tree) - HOST_ENTRIES)

        return save
    return save_pytree


def barrier() -> None:
    """Wait for every rank (one process: nothing): a stage's files are
    written by rank 0 before any rank reads them."""
    from devit_tpu_torch import runtime

    if runtime.distributed():
        torch.distributed.barrier()


def parallel_context(log=None, num_divisions: Optional[int] = None):
    """The layout of a stage under several ranks, or None in one process:
    the counterpart of the JAX CLI's data_parallel_context (no
    num_divisions: stages 2-4, the DDP replacement; the reference trains
    every stage under 8-GPU DDP, train_subdata.py:399-401 + README.md:50)
    and ensemble_parallel_context (stage 5: ensemble_layout's rule, the
    division-stacked state and gates sharded over 'div' by
    parallel/mesh.shard_state, the EnsMLP token fusion a gather over the
    division group). A step under it takes its rows of each global batch
    over 'data'; a batch the ranks do not divide (the last drop_last=False
    eval batch) is computed whole on every rank, with a warning the first
    time."""
    from devit_tpu_torch import runtime
    from devit_tpu_torch.parallel import mesh as M

    if runtime.world_size() == 1:
        return None
    layout = M.data_layout() if num_divisions is None else M.ensemble_layout(num_divisions)
    layout.log = log.info if log is not None else None
    if log is not None:
        log.info(f"layout over {layout.world} ranks: {layout.shape}")
    return layout


def batch_to(images: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host uint8 batch -> a tensor on `device` (writable memory)."""
    return torch.from_numpy(np.require(images, requirements=("C", "W"))).to(device)


def make_eval_prepare(img_size: int, dtype=torch.bfloat16, device="cpu"):
    dev = torch.device(device)
    return lambda images: eval_transform(batch_to(images, dev), img_size, dtype)


def train_steps_per_epoch(train_ds, args) -> int:
    """Steps the train BatchIterator yields per epoch (repeated augmentation
    truncates the epoch: the schedule must match). A division smaller than
    one batch would silently train zero steps under drop_last; raise."""
    n = len(BatchIterator(train_ds, args.batch_size, shuffle=True,
                          repeated_aug=3 if args.repeated_aug else 0))
    if n == 0:
        raise ValueError(f"division has {len(train_ds)} samples - fewer than one drop_last "
                         f"batch of {args.batch_size}; lower --batch-size")
    return n


def make_train_prepare(aug_cfg: AugmentConfig, dtype=torch.bfloat16, device="cpu"):
    dev = torch.device(device)
    return lambda gen, images: train_transform(gen, batch_to(images, dev), aug_cfg, dtype)


def make_train_pipeline(args, aug_cfg: AugmentConfig, dtype=torch.bfloat16, device="cpu"):
    """(prep_fn, host_transform): where train augmentation runs, as the JAX
    CLI picks it. auto: RandAugment (past small images) and AutoAugment on
    the host (PIL in the prefetch thread, data/host_augment.py), then
    normalize + random erasing on the device; otherwise everything on the
    device. prep_fn(generator, images) draws from the step's generator."""
    backend = getattr(args, "aug_backend", "auto")
    if aug_cfg.no_aug:
        # deterministic no-aug path is device-only: the host pipeline applies
        # RRC/hflip unconditionally
        return make_train_prepare(aug_cfg, dtype, device), None
    use_host = backend == "host" or (backend == "auto" and (
        aug_cfg.autoaugment is not None or (aug_cfg.randaugment and not aug_cfg.small_image)))
    if backend == "device" and aug_cfg.autoaugment is not None:
        raise ValueError("--aa original/cifar10 (AutoAugment) is host-PIL only; drop "
                         "--aug-backend device")
    if (backend == "host" and not aug_cfg.randaugment and aug_cfg.autoaugment is None
            and aug_cfg.color_jitter > 0):
        raise ValueError("--aug-backend host implements the RandAugment/AutoAugment policies "
                         "only; color-jitter training (--aa '') uses the device pipeline "
                         "(auto does)")
    if use_host:
        from devit_tpu_torch.data.host_augment import make_host_train_augment

        host_tf = make_host_train_augment(aug_cfg, seed=args.seed)
        dev = torch.device(device)
        return (lambda gen, images: finish_transform(gen, batch_to(images, dev), aug_cfg,
                                                     dtype)), host_tf
    return make_train_prepare(aug_cfg, dtype, device), None


def setup(args):
    """Runtime, output dir, logger, and the flag set as training_args.json
    (the reference pickles args into training_args.bin)."""
    from devit_tpu_torch.runtime import is_main_process, setup_runtime

    setup_runtime(getattr(args, "device", "cuda"))
    os.makedirs(args.output_dir, exist_ok=True)
    log = create_logger(args.output_dir)
    if is_main_process():
        with open(os.path.join(args.output_dir, "training_args.json"), "w") as f:
            json.dump({k: v for k, v in vars(args).items() if k != "fn"}, f, indent=1,
                      default=str)
    return log


def first_train_batch(train_ds, batch_size: int, seed: int = 0):
    """One drop_last batch for the single-batch HSIC ranking (imp_rank.py
    ranks on exactly one loader batch)."""
    for batch in BatchIterator(train_ds, batch_size, shuffle=True, seed=seed, prefetch=0):
        return batch
    raise ValueError(f"division has {len(train_ds)} samples - fewer than one drop_last "
                     f"ranking batch of {batch_size}; lower --batch-size")

