"""`devit-torch inspect`: checkpoint/artifact introspection (a copy of
devit_tpu/cli/inspect_ckpt.py over the port's own msgpack and orbax
readers).

Answers "what is this file?" for every artifact the framework (or the
reference) produces, without needing model flags: format, family, geometry,
training progress, gate sparsity, parameter count. The reference has no
equivalent (its users read `torch.load(...).keys()` by hand); for migrating
users this is the first debugging tool they reach for when a checkpoint
doesn't load.

Recognized inputs:
  *.pth / *.pt        reference-layout torch state dict (ViT or CCT family),
                      or a full reference training checkpoint (model/optimizer/
                      epoch dict, train_subdata.py:450-459)
  *.npz               Flax ViT weights (reference de_vit.py:372-449 layout)
  *.npy               shrink-stage policy/accuracy artifacts (shrink.py:417)
  *.msgpack / dir     our checkpoints: stage trees ({params, ema_params,
                      opt_state, epoch[, gates]}), ensemble trees
                      ({backbone_params, ens_params, ...}), compact serving
                      artifacts ({embed, layers, head, meta})
  manifest .json      DivisionManifest (stage-1 split)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["summarize_artifact", "inspect_main"]


def _walk_arrays(tree: Any, prefix: str = ""):
    """Yield (path, np-like leaf) for every array leaf in nested dicts/lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_arrays(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_arrays(v, f"{prefix}{i}/")
    elif hasattr(tree, "shape") and hasattr(tree, "dtype"):
        yield prefix.rstrip("/"), tree


def _dtype(leaf) -> tuple:
    """(name, itemsize) of a numpy leaf, or of a torch tensor (the codec's
    bfloat16 leaves) under numpy's name for it."""
    if hasattr(leaf, "element_size"):
        return str(leaf.dtype).replace("torch.", ""), leaf.element_size()
    return str(np.dtype(leaf.dtype)), np.dtype(leaf.dtype).itemsize


def _tree_stats(tree: Any) -> Dict[str, Any]:
    n_params = 0
    n_bytes = 0
    dtypes: Dict[str, int] = {}
    n_leaves = 0
    for _, leaf in _walk_arrays(tree):
        n_leaves += 1
        size = int(np.prod(leaf.shape)) if leaf.shape else 1
        name, itemsize = _dtype(leaf)
        n_params += size
        n_bytes += size * itemsize
        dtypes[name] = dtypes.get(name, 0) + 1
    return {"param_count": n_params, "byte_size": n_bytes,
            "leaf_count": n_leaves, "dtypes": dtypes}


def _vit_geometry(params: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Geometry from OUR scan-stacked ViT param tree (models/vit.py layout).
    Handles both a single tree and a division-stacked ensemble backbone tree
    (every leaf carries a leading D axis)."""
    blocks = params.get("blocks")
    if (not isinstance(blocks, dict) or "qkv" not in blocks
            or "pre_norm" in blocks):  # pre_norm => CCT, not ViT
        return None
    qkv = np.asarray(blocks["qkv"]["kernel"].shape)
    stacked = qkv.size == 4  # (D, L, C, 3C) vs (L, C, 3C)
    off = 1 if stacked else 0
    g: Dict[str, Any] = {
        "family": "vit",
        "depth": int(qkv[off]),
        "embed_dim": int(qkv[off + 1]),
    }
    if stacked:
        g["divisions"] = int(qkv[0])
    if "fc1" in blocks:
        g["mlp_hidden"] = int(np.asarray(blocks["fc1"]["kernel"].shape)[off + 2])
    pe = params.get("pos_embed")
    if pe is not None:
        seq = int(pe.shape[off + 1])
        g["seq_len"] = seq
        g["distilled"] = "dist_token" in params
        tokens = seq - (2 if g["distilled"] else 1)
        grid = int(round(tokens ** 0.5))
        patch = params.get("patch_embed", {}).get("kernel")
        if patch is not None and grid * grid == tokens:
            # our PatchEmbed is a Dense over flattened patches: (p*p*3, C)
            p = int(round((int(patch.shape[off]) / 3) ** 0.5))
            if p * p * 3 == int(patch.shape[off]):
                g["patch_size"] = p
                g["img_size"] = grid * p
    head = params.get("head", {}).get("kernel")
    if head is not None:
        g["num_classes"] = int(head.shape[-1])
    for k in ("resize_mlp", "resize_att_mlp", "resize_encoder_mlp"):
        if k in params:
            g.setdefault("resize_heads", []).append(k)
    return g


def _cct_geometry(params: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    blocks = params.get("blocks")
    if not isinstance(blocks, dict) or "pre_norm" not in blocks:
        return None
    qkv = np.asarray(blocks["qkv"]["kernel"].shape)
    stacked = qkv.size == 4
    off = 1 if stacked else 0
    g: Dict[str, Any] = {
        "family": "cct",
        "depth": int(qkv[off]),
        "embed_dim": int(qkv[off + 1]),
        "n_conv_layers": sum(1 for k in params.get("tokenizer", {})
                             if k.startswith("conv")),
        "seq_pool": "attention_pool" in params,
        "positional_emb": ("learnable" if "positional_emb" in params
                           else "sine-or-none"),
    }
    if stacked:
        g["divisions"] = int(qkv[0])
    fc = params.get("fc", {}).get("kernel")
    if fc is not None:
        g["num_classes"] = int(fc.shape[-1])
    return g


def _gate_summary(gates: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name in ("head", "neuron"):
        if gates.get(name) is None:
            continue
        arr = np.asarray(gates[name])
        kept = (arr > 0).sum(axis=-1)  # (L,) or (D, L)
        out[name] = {
            "total_per_layer": int(arr.shape[-1]),
            "kept_per_layer": kept.tolist(),
            "kept_fraction": float((arr > 0).mean()),
        }
    return out


def _summarize_params_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    # CCT first: its blocks contain BOTH 'pre_norm' and 'qkv', so the
    # looser ViT signature would otherwise claim every CCT tree
    return _cct_geometry(tree) or _vit_geometry(tree) or {"family": "unknown"}


def _summarize_ours(tree: Any, info: Dict[str, Any]) -> Dict[str, Any]:
    if not isinstance(tree, dict):
        info["kind"] = "raw pytree"
        info.update(_tree_stats(tree))
        return info
    keys = set(tree)
    if {"embed", "layers", "meta"} <= keys:
        meta = tree["meta"]
        heads = np.asarray(meta["num_heads"]).tolist()
        layers = tree["layers"]
        hidden = [int(np.asarray(layers[str(i)]["fc1_kernel"].shape)[-1])
                  for i in range(len(heads))]
        info["kind"] = "compact serving artifact"
        info["geometry"] = {
            "family": "vit-compact",
            "depth": len(heads),
            "embed_dim": int(np.asarray(tree["embed"]["pos_embed"].shape)[-1]),
            "head_dim": int(meta["head_dim"]),
            "distilled": bool(int(np.asarray(meta["distilled"]))),
            "layer_norm_eps": float(np.asarray(meta["eps"])),
            "kept_heads_per_layer": heads,
            "kept_neurons_per_layer": hidden,
        }
        head = tree.get("head", {}).get("head", {}).get("kernel")
        if head is not None:
            info["geometry"]["num_classes"] = int(head.shape[-1])
        info.update(_tree_stats(tree))
        return info
    if {"backbone_params", "ens_params"} <= keys:
        info["kind"] = "ensemble checkpoint (stage 5)"
        info["geometry"] = _summarize_params_tree(tree["backbone_params"])
        ens = tree["ens_params"]
        cls_head = ens.get("cls_classifier", {})
        if isinstance(cls_head, dict) and "kernel" in cls_head:
            info["geometry"]["ens_num_classes"] = int(cls_head["kernel"].shape[-1])
        info["contents"] = sorted(keys)
        if "epoch" in tree:
            info["epoch"] = int(np.asarray(tree["epoch"]))
        if isinstance(tree.get("gates"), dict):
            info["gates"] = _gate_summary(tree["gates"])
        info.update(_tree_stats(tree))
        return info
    if "params" in keys:
        info["kind"] = "stage checkpoint"
        info["geometry"] = _summarize_params_tree(tree["params"])
        info["contents"] = sorted(keys)
        info["has_ema"] = tree.get("ema_params") is not None
        info["has_opt_state"] = tree.get("opt_state") is not None
        if "epoch" in tree:
            info["epoch"] = int(np.asarray(tree["epoch"]))
        if isinstance(tree.get("gates"), dict):
            info["gates"] = _gate_summary(tree["gates"])
        info.update(_tree_stats(tree))
        return info
    # bare params tree (e.g. convert output with implicit {'params': ...}
    # unwrapped, or hand-rolled)
    geo = _summarize_params_tree(tree)
    info["kind"] = "bare param tree" if geo["family"] != "unknown" else "pytree"
    info["geometry"] = geo
    info.update(_tree_stats(tree))
    return info


def _summarize_torch(path: str, info: Dict[str, Any]) -> Dict[str, Any]:
    from devit_tpu_torch.io.checkpoint import _to_np

    import torch

    raw = torch.load(path, map_location="cpu", weights_only=False)
    src = raw
    if isinstance(raw, dict):
        nested = [k for k in ("model", "state_dict", "model_ema")
                  if isinstance(raw.get(k), dict)]
        if nested:
            # full reference training checkpoint (train_subdata.py:450-459)
            # or a {'state_dict': ...}-wrapped export
            info["kind"] = "reference training checkpoint"
            info["contents"] = sorted(k for k in raw if not k.startswith("_"))
            if "epoch" in raw:
                try:
                    info["epoch"] = int(raw["epoch"])
                except (TypeError, ValueError):
                    pass
            src = raw[nested[0]]
    sd = {k: _to_np(v) for k, v in src.items() if hasattr(v, "shape")}
    info.setdefault("kind", "reference state dict")
    g: Dict[str, Any] = {}
    if any(k.startswith("classifier.blocks.") or k.startswith("encoders.blocks.")
           for k in sd):
        pre = ("classifier." if any(k.startswith("classifier.") for k in sd)
               else "encoders.")
        g["family"] = "cct"
        g["depth"] = 1 + max(int(k.split(".")[2])
                             for k in sd if k.startswith(f"{pre}blocks."))
        g["embed_dim"] = int(sd[f"{pre}blocks.0.pre_norm.weight"].shape[0])
        if f"{pre}fc.weight" in sd:
            g["num_classes"] = int(sd[f"{pre}fc.weight"].shape[0])
        g["n_conv_layers"] = sum(1 for k in sd
                                 if k.startswith("tokenizer.conv_layers.")
                                 and k.endswith(".0.weight"))
    elif any(k.startswith("blocks.") for k in sd):
        g["family"] = "vit"
        g["depth"] = 1 + max(int(k.split(".")[1]) for k in sd
                             if k.startswith("blocks."))
        if "pos_embed" in sd:
            g["embed_dim"] = int(sd["pos_embed"].shape[-1])
            g["seq_len"] = int(sd["pos_embed"].shape[1])
        g["distilled"] = "dist_token" in sd
        if "head.weight" in sd:
            g["num_classes"] = int(sd["head.weight"].shape[0])
        if "patch_embed.proj.weight" in sd:
            g["patch_size"] = int(sd["patch_embed.proj.weight"].shape[-1])
    info["geometry"] = g or {"family": "unknown"}
    info.update(_tree_stats(sd))
    return info


def _summarize_npy(path: str, info: Dict[str, Any]) -> Dict[str, Any]:
    arr = np.load(path)
    info["kind"] = "shrink artifact (ndarray)"
    info["shape"] = list(arr.shape)
    info["dtypes"] = {str(arr.dtype): 1}
    base = os.path.basename(path)
    sib_name = None
    if "policy" in base:
        sib_name = base.replace("policy", "accuracy")
    elif "accuracy" in base:
        sib_name = base.replace("accuracy", "policy")
    sib = os.path.join(os.path.dirname(path), sib_name) if sib_name else None
    if sib and os.path.exists(sib) and sib != path:
        pol = arr if "policy" in base else np.load(sib)
        acc = np.load(sib) if "policy" in base else arr
        best = int(np.argmax(acc))
        info["candidates"] = int(len(acc))
        info["best_index"] = best
        info["best_accuracy"] = float(np.asarray(acc[best]).ravel()[0])
        row = np.asarray(pol[best], dtype=float)
        L = row.size // 2
        info["best_policy"] = {
            "neuron_sparsity": row[:L].tolist(),
            "head_sparsity": row[L:].tolist(),
        }
    return info


def summarize_artifact(path: str) -> Dict[str, Any]:
    """Inspect one artifact; returns a JSON-able summary dict."""
    info: Dict[str, Any] = {"path": path}
    if path.endswith((".pth", ".pt")):
        info["format"] = "torch"
        return _summarize_torch(path, info)
    if path.endswith(".npy"):
        info["format"] = "npy"
        return _summarize_npy(path, info)
    if path.endswith(".npz"):
        from devit_tpu_torch.io.checkpoint import load_flax_npz_vit

        info["format"] = "npz"
        w = np.load(path)
        enc = [k for k in w.files if "encoderblock_" in k]
        if not enc:
            # not the flax-ViT layout — describe rather than crash
            info["kind"] = "npz archive (unrecognized layout)"
            info["keys"] = sorted(w.files)[:40]
            info.update(_tree_stats({k: w[k] for k in w.files}))
            return info
        info["format"] = "flax-npz"
        depth = 1 + max(int(k.split("encoderblock_")[1].split("/")[0])
                        for k in enc)
        params = load_flax_npz_vit(path, depth=depth)
        info["kind"] = "flax ViT weights (reference de_vit.py:372-449 layout)"
        info["geometry"] = _summarize_params_tree(params)
        info.update(_tree_stats(params))
        return info
    if path.endswith(".json"):
        with open(path) as f:
            d = json.load(f)
        if isinstance(d, dict) and "divisions" in d:
            info["format"] = "json"
            info["kind"] = "division manifest (stage 1)"
            divs = d["divisions"]
            info["num_divisions"] = len(divs)
            info["classes_per_division"] = [len(c) for c in divs]
            for k in ("seed", "num_classes", "num_division"):
                if k in d:
                    info[k] = d[k]
            return info
        info["format"] = "json"
        info["kind"] = "json"
        info["keys"] = sorted(d) if isinstance(d, dict) else None
        return info
    from devit_tpu_torch.io.checkpoint import orbax_path, restore_pytree

    # restore_pytree's dispatch: a directory (or its crash-cut '.new'), or the
    # '.msgpack' name --ckpt-format orbax rewrote to '.orbax', is orbax
    info["format"] = "msgpack" if orbax_path(path) is None else "orbax"
    tree = restore_pytree(path)
    return _summarize_ours(tree, info)


_GEO_ORDER = ("family", "divisions", "depth", "embed_dim", "mlp_hidden",
              "head_dim", "patch_size", "img_size", "seq_len", "num_classes",
              "ens_num_classes", "distilled", "n_conv_layers", "seq_pool",
              "positional_emb", "layer_norm_eps", "resize_heads")


def _print_human(info: Dict[str, Any]) -> None:
    print(f"path:    {info['path']}")
    print(f"format:  {info['format']}")
    if "kind" in info:
        print(f"kind:    {info['kind']}")
    g = info.get("geometry")
    if g:
        parts = [f"{k}={g[k]}" for k in _GEO_ORDER if k in g]
        print(f"geometry: {', '.join(parts)}")
        for k in ("kept_heads_per_layer", "kept_neurons_per_layer"):
            if k in g:
                print(f"  {k}: {g[k]}")
    if "epoch" in info:
        print(f"epoch:   {info['epoch']} (a --resume continues at "
              f"{info['epoch'] + 1})")
    if "contents" in info:
        print(f"contents: {', '.join(info['contents'])}")
    for flag in ("has_ema", "has_opt_state"):
        if flag in info:
            print(f"{flag}: {info[flag]}")
    if "gates" in info:
        for name, gsum in info["gates"].items():
            print(f"gates[{name}]: kept {gsum['kept_fraction']:.1%} of "
                  f"{gsum['total_per_layer']}/layer; per layer "
                  f"{gsum['kept_per_layer']}")
    if "param_count" in info:
        mb = info["byte_size"] / 1e6
        print(f"params:  {info['param_count']:,} ({mb:.1f} MB, "
              f"{info['leaf_count']} leaves)")
    if "dtypes" in info:
        print(f"dtypes:  {info['dtypes']}")
    for k in ("shape", "candidates", "best_index", "best_accuracy"):
        if k in info:
            print(f"{k}: {info[k]}")
    if "best_policy" in info:
        bp = info["best_policy"]
        print(f"best policy neuron sparsity: {bp['neuron_sparsity']}")
        print(f"best policy head sparsity:   {bp['head_sparsity']}")
    if "num_divisions" in info:
        print(f"divisions: {info['num_divisions']} "
              f"(classes per division {info['classes_per_division']})")


def inspect_main(args) -> int:
    from devit_tpu_torch.io.checkpoint import orbax_path

    infos: List[Dict[str, Any]] = []
    for path in args.paths:
        if not os.path.exists(path) and orbax_path(path) is None:
            raise FileNotFoundError(path)
        infos.append(summarize_artifact(path))
    if args.json:
        print(json.dumps(infos if len(infos) > 1 else infos[0], indent=2))
    else:
        for i, info in enumerate(infos):
            if i:
                print()
            _print_human(info)
    return 0
