"""The port's CLI: `devit-torch <stage> [flags]` or
`python -m devit_tpu_torch.cli <stage> [flags]` (counterpart of
devit_tpu/cli/__main__.py: the same subcommands, flags and defaults, plus
--device {cuda,cpu} on every subcommand, default cuda).

Stages mirror the reference's five entry scripts plus deploy/serve
(README.md:40-69):
  split     — class-disjoint partition manifest   (splite_dataset.py)
  train_sub — finetune one division's sub-model   (train_subdata.py)
  shrink    — HSIC rank + MACs policy search      (shrink.py)
  distill   — DEKD distillation with shrink masks (distill_sub.py)
  ensemble  — token-fusion ensemble training/eval (ensemble.py)

`bench` raises: the port's benchmark waits for ROADMAP Queue 1 item 1.
Checkpoints are msgpack files or, with --ckpt-format orbax, the JAX
package's orbax directories; every stage, convert, inspect and serve read
both. Both model families (ViT/DeiT and CCT) run.
"""

from __future__ import annotations

import argparse
import sys

from devit_tpu_torch.cli import common as C
from devit_tpu_torch.cli import stages


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("devit-torch", description=__doc__)
    sub = p.add_subparsers(dest="stage", required=True)

    sp = sub.add_parser("split", help="stage 1: class-disjoint split manifest")
    C.add_data_args(sp)
    sp.add_argument("--materialize", action="store_true",
                    help="additionally export the reference's physical "
                         "sub-dataset{i}/{train,test}_dataset/<class> "
                         "ImageFolder trees (splite_dataset.py layout) for "
                         "external tooling; needs <data-path>/train + "
                         "val|test class dirs. devit stages only need the "
                         "manifest")
    sp.add_argument("--materialize-copy", action="store_true",
                    help="copy files instead of hardlinking when "
                         "materializing")
    sp.set_defaults(fn=stages.split_main)

    tp = sub.add_parser("train_sub", help="stage 2: train one division sub-model")
    for add in (C.add_model_args, C.add_optim_args, C.add_aug_args,
                C.add_distill_args, C.add_data_args):
        add(tp)
    tp.set_defaults(fn=stages.train_sub_main)

    sh = sub.add_parser("shrink", help="stage 3: rank + shrink policy search")
    for add in (C.add_model_args, C.add_optim_args, C.add_aug_args, C.add_data_args):
        add(sh)
    sh.add_argument("--shrink-ratio", type=float, default=0.3)
    sh.add_argument("--population", type=int, default=50)
    sh.add_argument("--lb", type=float, default=0.0)
    sh.add_argument("--ub", type=float, default=0.9)
    sh.add_argument("--candidate-chunk", type=int, default=8)
    sh.set_defaults(fn=stages.shrink_main, model="dedeit")

    dp = sub.add_parser("distill", help="stage 4: DEKD distillation")
    for add in (C.add_model_args, C.add_optim_args, C.add_aug_args,
                C.add_distill_args, C.add_data_args):
        add(dp)
    dp.add_argument("--gama", type=float, nargs=3, default=[0.2, 0.1, 0.3],
                    help="q/k/v relation-loss weights (distill_sub gama flag)")
    dp.add_argument("--policy-path", type=str, default=None,
                    help="dir with shrinked_policy.npy/shrinked_accuracy.npy")
    # BooleanOptionalAction so --no-distillation-inter actually disables the
    # q/k/v relation losses (the reference's `type=bool` flag can never be
    # turned off from the CLI — any string parses truthy; engine.py:69 still
    # branches on it, so the OFF path is reachable programmatically there)
    dp.add_argument("--distillation-inter", action=argparse.BooleanOptionalAction,
                    default=True)
    # reference distill_sub.py default: clip-grad 1.0 (:69). Its parser also
    # defaults teacher-model to vit_large (:141) but that is incompatible
    # with the dedeit student (197 vs 198 tokens breaks the relation loss in
    # both frameworks) and the canonical command always passes the DeiT
    # teacher (README.md:62) — keep the working default.
    dp.set_defaults(fn=stages.distill_main, model="dedeit", distillation_type="hard",
                    clip_grad=1.0)

    ep = sub.add_parser("ensemble", help="stage 5: token-fusion ensemble")
    for add in (C.add_model_args, C.add_optim_args, C.add_aug_args,
                C.add_distill_args, C.add_data_args):
        add(ep)
    ep.add_argument("--sub-model-path", type=str, default=None,
                    help="dir with sub-dataset{i}/checkpoint.{msgpack,pth}")
    ep.add_argument("--gates-path", type=str, default=None)
    ep.add_argument("--teacher-size", type=int, default=768)
    ep.add_argument("--ens-lr", type=float, default=None)
    ep.add_argument("--compact-path", type=str, default=None,
                    help="eval from deploy-stage compact artifacts (serving path)")
    ep.add_argument("--ens-path", type=str, default=None,
                    help="EnsMLP checkpoint for compact-path eval")
    # reference ensemble.py defaults: lr 1e-5 (:77), weight-decay 0.05 (:72)
    # — materially different from the stage-2 recipe (teacher stays DeiT: the
    # canonical command overrides the parser's vit_large, README.md:68)
    ep.set_defaults(fn=stages.ensemble_main, model="dedeit",
                    lr=1e-5, weight_decay=0.05)

    bp = sub.add_parser("bench", help="deployed-ensemble throughput benchmark (not ported "
                                      "yet: raises, ROADMAP Queue 1 item 1)")
    bp.add_argument("--batch-size", type=int, default=256)  # measured optimum
    # (batch sweep in bench.py: 256 gives 4730 img/s vs 4089 at 512)
    mode = bp.add_mutually_exclusive_group()
    mode.add_argument("--latency", type=str, default=None, metavar="BS,BS,...",
                      help="latency mode: per-batch ms at these batch sizes "
                           "(e.g. 1,16,256) instead of throughput")
    mode.add_argument("--train", action="store_true",
                      help="training mode: stage-2 train step ms/step + MFU "
                           "instead of serving throughput")
    mode.add_argument("--topology", action="store_true",
                      help="deployment-topology mode: with >1 local device, "
                           "run the collaborative serving topology "
                           "(parallel/serve.py) end-to-end and report "
                           "measured img/s; with 1 device, print the "
                           "measured-component multi-chip projection")
    bp.set_defaults(fn=_bench_main)

    pp = sub.add_parser("pipeline", help="run the whole chain: split -> "
                                         "train_sub/shrink/distill per division "
                                         "-> ensemble -> deploy under one root")
    for add in (C.add_model_args, C.add_optim_args, C.add_aug_args,
                C.add_distill_args, C.add_data_args):
        add(pp)
    pp.add_argument("--stages", type=str,
                    default="split,train_sub,shrink,distill,ensemble,deploy",
                    help="comma-separated subset of stages to run")
    pp.add_argument("--force", action="store_true",
                    help="re-run stages even when their artifacts exist")
    pp.add_argument("--shrink-ratio", type=float, default=0.3)
    pp.add_argument("--population", type=int, default=50)
    pp.add_argument("--lb", type=float, default=0.0)
    pp.add_argument("--ub", type=float, default=0.9)
    pp.add_argument("--candidate-chunk", type=int, default=8)
    pp.add_argument("--gama", type=float, nargs=3, default=[0.2, 0.1, 0.3])
    pp.add_argument("--distillation-inter", action=argparse.BooleanOptionalAction,
                    default=True)
    pp.add_argument("--teacher-size", type=int, default=768)
    pp.add_argument("--ens-lr", type=float, default=None)
    pp.add_argument("--ens-backbone-lr", type=float, default=None,
                    help="stage-5 backbone LR (default: reference recipe "
                         "1e-5 unless --lr was moved off its default)")
    pp.add_argument("--ens-weight-decay", type=float, default=None,
                    help="stage-5 weight decay (default: reference 0.05 "
                         "unless --weight-decay was moved off its default)")
    pp.add_argument("--deploy-num-classes", type=int, default=25)
    pp.add_argument("--neuron-multiple", type=int, default=128)
    # None sentinels so pipeline_main can tell an EXPLICIT --lr 5e-4 /
    # --weight-decay 0.0 from unset (the ensemble stage has its own
    # reference recipe, 1e-5/0.05, that must only apply when unset)
    pp.set_defaults(fn=stages.pipeline_main, model="dedeit",
                    lr=None, weight_decay=None)

    dep = sub.add_parser("deploy", help="compact division checkpoints into serving artifacts")
    C.add_model_args(dep)
    C.add_data_args(dep)
    dep.add_argument("--sub-model-path", type=str, default=None,
                     help="dir with sub-dataset{i}/checkpoint.msgpack (distill outputs)")
    dep.add_argument("--ensemble-path", type=str, default=None,
                     help="stage-5 ensemble checkpoint: compact the "
                          "ensemble-TRAINED stacked backbones (+ persisted "
                          "gates) instead of the distill checkpoints")
    dep.add_argument("--deploy-num-classes", type=int, default=25)
    dep.add_argument("--neuron-multiple", type=int, default=128)
    dep.set_defaults(fn=stages.deploy_main, model="dedeit")

    ig = sub.add_parser("ingest", help="pre-build the decoded dataset cache "
                                       "(train+val; memmap past "
                                       "DEVIT_MMAP_BYTES)")
    C.add_data_args(ig)
    ig.add_argument("--input-size", type=int, default=224)
    ig.set_defaults(fn=stages.ingest_main)

    sv = sub.add_parser("serve", help="HTTP serving daemon over deploy-stage "
                                      "compact artifacts (POST /predict, GET "
                                      "/healthz, GET /stats; micro-batching "
                                      "into fixed buckets)")
    sv.add_argument("--compact-path", type=str, required=True,
                    help="dir with sub-dataset{i}/compact.msgpack (devit deploy)")
    sv.add_argument("--ens-path", type=str, default=None,
                    help="stage-5 fusion checkpoint, msgpack or orbax (omit = smoke "
                         "mode with a random fusion head)")
    sv.add_argument("--num-division", type=int, default=0,
                    help="0 = auto-discover contiguous sub-dataset{i} dirs")
    sv.add_argument("--host", type=str, default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--buckets", type=str, default="1,8,32,128,256",
                    help="comma-separated batch buckets (requests pad to the "
                         "smallest fitting bucket)")
    sv.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="micro-batching coalescing window")
    sv.add_argument("--topk", type=int, default=5)
    sv.add_argument("--input-size", type=int, default=224)
    sv.add_argument("--patch-size", type=int, default=16)
    sv.add_argument("--teacher-size", type=int, default=768,
                    help="fusion width fallback when no --ens-path (inferred "
                         "from the checkpoint otherwise)")
    sv.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    sv.add_argument("--no-fast-math", action="store_true",
                    help="serving defaults to fast_math like bench.py; this "
                         "pins the parity numerics instead")
    sv.add_argument("--no-warmup", action="store_true",
                    help="skip running every bucket once at startup")
    sv.add_argument("--aot-cache", choices=["auto", "on", "off"],
                    default="auto",
                    help="the JAX daemon's AOT executable cache: the port "
                         "compiles no bucket programs, so auto and off are "
                         "accepted and on raises")
    sv.set_defaults(fn=_serve_main)

    cv = sub.add_parser("convert", help="convert checkpoints: torch .pth/.pt "
                                        "<-> msgpack/orbax, flax .npz -> ours "
                                        "(geometry inferred from the file)")
    cv.add_argument("src", help=".pth/.pt/.npz/.msgpack/.orbax input")
    cv.add_argument("dst", help=".msgpack/.orbax/.pth/.pt output")
    cv.add_argument("--ema", action="store_true",
                    help="export the EMA parameters instead of the raw ones")
    cv.set_defaults(fn=stages.convert_main)

    ip = sub.add_parser("inspect", help="introspect checkpoints/artifacts: "
                                        "format, family, geometry, epoch, "
                                        "gates, param count (no model flags "
                                        "needed)")
    ip.add_argument("paths", nargs="+",
                    help=".pth/.pt/.npz/.npy/.msgpack/manifest.json")
    ip.add_argument("--json", action="store_true",
                    help="machine-readable JSON instead of the human summary")
    ip.set_defaults(fn=_inspect_main)

    for sp_ in sub.choices.values():
        C.add_device_arg(sp_)
    return p


def _inspect_main(args):
    from devit_tpu_torch.cli.inspect_ckpt import inspect_main

    return inspect_main(args)


def _serve_main(args):
    from devit_tpu_torch.serving.daemon import serve_main

    serve_main(args)


def _bench_main(args):
    raise NotImplementedError(
        "bench: the port has no benchmark yet; it waits for a benchmark PR (ROADMAP Queue 1 "
        "item 1). chip_smoke.py drives and times the port on the card meanwhile")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
