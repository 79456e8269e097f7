"""Checkpoint save/restore in the JAX package's msgpack format and the
ingestion of torch and Flax .npz ViT checkpoints (counterpart of
devit_tpu/io/checkpoint.py: :28-58, the msgpack part, and :159-476), over
the port's own msgpack codec (io/msgpack.py), so a file either package
writes, the other reads. Orbax checkpoint directories are not read:
restore_pytree raises on one.

The converters produce and take the JAX package's parameter tree (nested
dicts of numpy arrays, `blocks/*` leaves stacked over depth), which
io/bridge.py `vit_from_jax_params` loads into the port's module. The CCT
converters come with the CCT slice.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from devit_tpu_torch.io import msgpack


def save_pytree(path: str, tree: Any) -> None:
    """Atomic msgpack save, as flax.serialization.to_bytes writes the tree:
    write a temporary file, then os.replace, so a crash mid-write never
    truncates the previous good file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(msgpack.to_bytes(tree))
    os.replace(tmp, path)


def _orbax_dir(path: str) -> bool:
    """The JAX package's orbax layouts: a directory (or its '.new' promotion
    left by a crash), or a '.msgpack' name whose '.orbax' sibling is one."""
    if os.path.isdir(path) or os.path.isdir(path + ".new"):
        return True
    if not os.path.exists(path) and path.endswith(".msgpack"):
        sibling = path[: -len(".msgpack")] + ".orbax"
        return os.path.isdir(sibling) or os.path.isdir(sibling + ".new")
    return False


def restore_pytree(path: str) -> Any:
    """The raw tree of a msgpack checkpoint (flax's msgpack_restore: nested
    dicts, numpy leaves, bfloat16 as torch tensors, chunked arrays joined).
    Raises ValueError on an orbax checkpoint directory or malformed data,
    FileNotFoundError on a missing file."""
    if _orbax_dir(path):
        raise ValueError(f"{path!r} is an orbax checkpoint directory; the port reads "
                         "msgpack checkpoints only (orbax is not ported yet)")
    with open(path, "rb") as f:
        data = f.read()
    return msgpack.restore(data)


# ------------------------------------------------------- torch ingestion


def _to_np(t) -> np.ndarray:
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def _stack(trees) -> Any:
    """Nested dicts of arrays, one per layer -> one tree, leaves stacked on a
    new leading axis (jax.tree_util.tree_map(np.stack) on dicts, which also
    sorts each dict's keys: a checkpoint written from it has flax's bytes)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in sorted(trees[0])}
    return np.stack(trees)


def _map(fn, tree) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch .pth file on the CPU; unwraps the {'model': ...} (or
    {'state_dict': ...}) nesting deit checkpoints use."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict):
        for key in ("model", "state_dict"):  # common checkpoint wrappers
            if isinstance(sd.get(key), dict):
                sd = sd[key]
                break
    return {k: _to_np(v) for k, v in sd.items() if hasattr(v, "shape")}


def torch_vit_to_params(sd: Dict[str, np.ndarray], depth: int) -> Dict:
    """Reference-layout ViT state_dict -> the JAX package's scan-stacked
    parameter tree (devit_tpu/io/checkpoint.py torch_vit_to_params):
      patch_embed.proj.{weight (D,3,p,p), bias} -> patch_embed.{kernel (p*p*3,D), bias}
          (torch's conv flattens (c, ph, pw), the patchify (ph, pw, c))
      cls_token/dist_token/pos_embed -> same names
      blocks.{i}.norm1.{weight,bias} -> blocks.norm1.{scale,bias}[i]  (stacked)
      blocks.{i}.attn.qkv.{weight,bias} -> blocks.qkv.{kernel.T, bias}[i]
      blocks.{i}.attn.proj, mlp.fc1, mlp.fc2 -> blocks.{proj,fc1,fc2}[i]
      norm.{weight,bias} -> norm.{scale,bias}
      head/head_dist -> head/head_dist (skipped where absent)
      resize_mlp / resize_att_mlp / resize_encoder_mlp -> same names
    """

    def lin(prefix):
        out = {"kernel": np.transpose(sd[f"{prefix}.weight"])}
        if f"{prefix}.bias" in sd:
            out["bias"] = sd[f"{prefix}.bias"]
        return out

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def stack(fn):
        return _stack([fn(i) for i in range(depth)])

    conv_w = sd["patch_embed.proj.weight"]  # (D, C, p, p)
    D, C, p, _ = conv_w.shape
    params: Dict[str, Any] = {
        "patch_embed": {"kernel": conv_w.transpose(2, 3, 1, 0).reshape(p * p * C, D),
                        "bias": sd["patch_embed.proj.bias"]},
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
        "norm": ln("norm"),
        "blocks": {
            "norm1": stack(lambda i: ln(f"blocks.{i}.norm1")),
            "qkv": stack(lambda i: lin(f"blocks.{i}.attn.qkv")),
            "proj": stack(lambda i: lin(f"blocks.{i}.attn.proj")),
            "norm2": stack(lambda i: ln(f"blocks.{i}.norm2")),
            "fc1": stack(lambda i: lin(f"blocks.{i}.mlp.fc1")),
            "fc2": stack(lambda i: lin(f"blocks.{i}.mlp.fc2")),
        },
    }
    if "dist_token" in sd:
        params["dist_token"] = sd["dist_token"]
    for name in ("head", "head_dist", "resize_mlp", "resize_att_mlp", "resize_encoder_mlp"):
        if f"{name}.weight" in sd:
            params[name] = lin(name)
    return params


def params_to_torch_vit(params: Dict, depth: int) -> Dict[str, np.ndarray]:
    """Inverse of torch_vit_to_params: the scan-stacked ViT parameter tree ->
    a reference-layout state_dict of f32 numpy values."""
    params = _map(lambda x: np.asarray(x, np.float32), params)
    sd: Dict[str, np.ndarray] = {}

    def lin(prefix, tree):
        sd[f"{prefix}.weight"] = np.transpose(tree["kernel"])
        if "bias" in tree:
            sd[f"{prefix}.bias"] = tree["bias"]

    def ln(prefix, tree):
        sd[f"{prefix}.weight"] = tree["scale"]
        sd[f"{prefix}.bias"] = tree["bias"]

    pk = params["patch_embed"]["kernel"]  # (p*p*C, D)
    D, C = pk.shape[1], 3
    p = int(round((pk.shape[0] // C) ** 0.5))
    sd["patch_embed.proj.weight"] = pk.reshape(p, p, C, D).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = params["patch_embed"]["bias"]
    for name in ("cls_token", "dist_token", "pos_embed"):
        if name in params:
            sd[name] = params[name]
    ln("norm", params["norm"])
    blocks = params["blocks"]
    for i in range(depth):
        sl = _map(lambda x: x[i], blocks)
        ln(f"blocks.{i}.norm1", sl["norm1"])
        lin(f"blocks.{i}.attn.qkv", sl["qkv"])
        lin(f"blocks.{i}.attn.proj", sl["proj"])
        ln(f"blocks.{i}.norm2", sl["norm2"])
        lin(f"blocks.{i}.mlp.fc1", sl["fc1"])
        lin(f"blocks.{i}.mlp.fc2", sl["fc2"])
    for name in ("head", "head_dist", "resize_mlp", "resize_att_mlp", "resize_encoder_mlp"):
        if name in params:
            lin(name, params[name])
    return sd


def _torch_cubic_weight(t: np.ndarray, A: float = -0.75) -> np.ndarray:
    """torch F.interpolate's bicubic kernel (cubic convolution, A = -0.75,
    not the Keys a = -0.5 spline of jax.image.resize)."""
    t = np.abs(t)
    return np.where(t <= 1, ((A + 2) * t - (A + 3)) * t * t + 1,
                    np.where(t < 2, ((A * t - 5 * A) * t + 8 * A) * t - 4 * A, 0.0))


def _torch_resize_1d(x: np.ndarray, out_len: int, axis: int, kind: str) -> np.ndarray:
    """One separable axis of torch F.interpolate(align_corners=False, no
    antialias): half-pixel source coordinates, edge-clamped taps."""
    in_len = x.shape[axis]
    src = (np.arange(out_len) + 0.5) * in_len / out_len - 0.5
    i0 = np.floor(src).astype(int)
    taps = range(-1, 3) if kind == "cubic" else range(0, 2)
    out = 0.0
    for k in taps:
        idx = np.clip(i0 + k, 0, in_len - 1)
        if kind == "cubic":
            w = _torch_cubic_weight(src - (i0 + k))
        else:  # linear tent kernel
            w = np.maximum(0.0, 1.0 - np.abs(src - (i0 + k)))
        shape = [1] * x.ndim
        shape[axis] = out_len
        out = out + np.take(x, idx, axis=axis) * w.reshape(shape)
    return out


def _resize_pe_grid(pos_embed: np.ndarray, new_seq_len: int, num_prefix_tokens: int, *,
                    method: str, family: str) -> np.ndarray:
    """The position-embedding grid resize (in f64, rounded to f32 once)."""
    tok = pos_embed[:, :num_prefix_tokens]
    grid = np.asarray(pos_embed[0, num_prefix_tokens:], np.float64)
    gs_old = int(np.sqrt(grid.shape[0]))
    gs_new = int(np.sqrt(new_seq_len - num_prefix_tokens))
    if gs_old * gs_old != grid.shape[0] or gs_new * gs_new != new_seq_len - num_prefix_tokens:
        # a prefix-token mismatch would misalign every token
        raise ValueError(
            f"{family} pos-embed grid not square: ckpt {grid.shape[0]} tokens, target "
            f"{new_seq_len - num_prefix_tokens} (prefix {num_prefix_tokens}) — prefix-token "
            f"mismatch?")
    if gs_old == gs_new:
        return pos_embed
    grid = grid.reshape(1, gs_old, gs_old, -1)
    grid = _torch_resize_1d(_torch_resize_1d(grid, gs_new, 1, method), gs_new, 2, method)
    grid = grid.astype(np.float32).reshape(1, gs_new * gs_new, -1)
    return np.concatenate([tok, grid], axis=1)


def resize_pos_embed(pos_embed: np.ndarray, new_seq_len: int,
                     num_prefix_tokens: int = 1) -> np.ndarray:
    """Bicubic grid resize of position embeddings as the reference's
    F.interpolate(mode='bicubic', align_corners=False) does it (no
    antialias)."""
    return _resize_pe_grid(pos_embed, new_seq_len, num_prefix_tokens, method="cubic",
                           family="ViT")


def resize_cct_pos_embed(pos_embed: np.ndarray, new_seq_len: int,
                         num_prefix_tokens: int = 0) -> np.ndarray:
    """Bilinear grid resize of a CCT's learnable positional embedding (the
    reference's helpers.py:26-32 `pe_check`, F.interpolate mode='bilinear';
    no prefix token under seq-pool, one with a class token), so a 224-px
    checkpoint lands in a 32-px model resized, not replaced."""
    return _resize_pe_grid(pos_embed, new_seq_len, num_prefix_tokens, method="linear",
                           family="CCT")


def torch_cct_to_params(sd: Dict[str, np.ndarray], num_layers: int, n_conv_layers: int) -> Dict:
    """Reference-layout CCT state_dict -> the JAX package's scan-stacked CCT
    parameter tree (devit_tpu/io/checkpoint.py torch_cct_to_params):
    tokenizer.conv_layers.{i}.0.weight (O, I, kh, kw) -> tokenizer/conv{i}/
    kernel (kh, kw, I, O); classifier.blocks.{i}.{pre_norm, self_attn.qkv,
    self_attn.proj, norm1, linear1, linear2} -> blocks/{pre_norm, qkv, proj,
    norm1, linear1, linear2} stacked over the layers; classifier.{norm,
    attention_pool, fc, class_emb, positional_emb} under the same names. A
    headless checkpoint's 'encoders.' prefix is taken as well."""
    pre = "classifier." if any(k.startswith("classifier.") for k in sd) else "encoders."

    def lin(name):
        out = {"kernel": np.transpose(sd[f"{name}.weight"])}
        if f"{name}.bias" in sd:
            out["bias"] = sd[f"{name}.bias"]
        return out

    def ln(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}

    def stack(fn):
        return _stack([fn(i) for i in range(num_layers)])

    params: Dict[str, Any] = {
        "tokenizer": {f"conv{i}": {"kernel": sd[f"tokenizer.conv_layers.{i}.0.weight"]
                                   .transpose(2, 3, 1, 0)} for i in range(n_conv_layers)},
        "blocks": {
            "pre_norm": stack(lambda i: ln(f"{pre}blocks.{i}.pre_norm")),
            "qkv": stack(lambda i: lin(f"{pre}blocks.{i}.self_attn.qkv")),
            "proj": stack(lambda i: lin(f"{pre}blocks.{i}.self_attn.proj")),
            "norm1": stack(lambda i: ln(f"{pre}blocks.{i}.norm1")),
            "linear1": stack(lambda i: lin(f"{pre}blocks.{i}.linear1")),
            "linear2": stack(lambda i: lin(f"{pre}blocks.{i}.linear2")),
        },
        "norm": ln(f"{pre}norm"),
    }
    if f"{pre}attention_pool.weight" in sd:
        params["attention_pool"] = lin(f"{pre}attention_pool")
    if f"{pre}class_emb" in sd:
        params["class_emb"] = sd[f"{pre}class_emb"]
    if f"{pre}positional_emb" in sd:
        params["positional_emb"] = sd[f"{pre}positional_emb"]
    if f"{pre}fc.weight" in sd:
        params["fc"] = lin(f"{pre}fc")
    if "resize.weight" in sd:
        params["resize"] = lin("resize")
    return params


def load_flax_npz_vit(path: str, depth: int) -> Dict:
    """A Google-Brain Flax .npz ViT checkpoint -> the scan-stacked tree."""
    w = np.load(path)
    prefix = "opt/target/" if "opt/target/embedding/kernel" in w else ""

    def g(name):
        return w[f"{prefix}{name}"]

    emb_k = g("embedding/kernel")  # (p, p, C, D) already HWC-major
    p, _, C, D = emb_k.shape

    def block(i):
        bp = f"Transformer/encoderblock_{i}/"
        mha = bp + "MultiHeadDotProductAttention_1/"
        qkv_k = np.concatenate(
            [g(f"{mha}{n}/kernel").reshape(D, -1) for n in ("query", "key", "value")], axis=1)
        qkv_b = np.concatenate([g(f"{mha}{n}/bias").reshape(-1) for n in ("query", "key", "value")])
        return {
            "norm1": {"scale": g(f"{bp}LayerNorm_0/scale"), "bias": g(f"{bp}LayerNorm_0/bias")},
            "qkv": {"kernel": qkv_k, "bias": qkv_b},
            "proj": {"kernel": g(f"{mha}out/kernel").reshape(-1, D), "bias": g(f"{mha}out/bias")},
            "norm2": {"scale": g(f"{bp}LayerNorm_2/scale"), "bias": g(f"{bp}LayerNorm_2/bias")},
            "fc1": {"kernel": g(f"{bp}MlpBlock_3/Dense_0/kernel"),
                    "bias": g(f"{bp}MlpBlock_3/Dense_0/bias")},
            "fc2": {"kernel": g(f"{bp}MlpBlock_3/Dense_1/kernel"),
                    "bias": g(f"{bp}MlpBlock_3/Dense_1/bias")},
        }

    params = {
        "patch_embed": {"kernel": emb_k.reshape(p * p * C, D), "bias": g("embedding/bias")},
        "cls_token": g("cls"),
        "pos_embed": g("Transformer/posembed_input/pos_embedding"),
        "norm": {"scale": g("Transformer/encoder_norm/scale"),
                 "bias": g("Transformer/encoder_norm/bias")},
        "blocks": _stack([block(i) for i in range(depth)]),
    }
    if f"{prefix}head/kernel" in w:
        params["head"] = {"kernel": g("head/kernel"), "bias": g("head/bias")}
    return params
