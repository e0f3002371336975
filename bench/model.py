"""A configuration file as the port runs it, and the weights both sides get.

The configuration files name their sizes as the published ``config.json``
does; :func:`port_config` maps them onto the port's ``ModelConfig``.
:func:`layout` is the benchmark's own statement of the parameter tree
(the port's layout: stacked layers, padded vocabulary), and
:func:`draw_weights` fills it from the seed on the device, in the dtype it
is served in, one ``torch.randn`` a leaf.  The same tensors go to the port
and to the plain reference.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def vocab_padded(cfg: dict) -> int:
    m = cfg["pad_vocab_to"]
    return -(-cfg["vocab_size"] // m) * m


def head_dim(cfg: dict) -> int:
    return (cfg.get("head_dim")
            or cfg["hidden_size"] // cfg["num_attention_heads"])


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import ModelConfig
    if cfg["hidden_act"] != "silu":
        raise ValueError(f"{cfg['name']}: only silu (swiglu) MLPs are mapped")
    kw = dict(
        name=cfg["name"], family=cfg["family"],
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=head_dim(cfg), mlp_act="swiglu",
        qk_norm=cfg["qk_norm"] is not None, qkv_bias=cfg["qkv_bias"],
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=cfg["tie_word_embeddings"],
        param_dtype=cfg["torch_dtype"], pad_vocab_to=cfg["pad_vocab_to"],
        source=cfg["source"])
    if cfg["family"] == "moe":
        kw.update(n_experts=cfg["num_experts"],
                  top_k=cfg["num_experts_per_tok"],
                  capacity_factor=cfg["capacity_factor"])
    return ModelConfig(**kw)


def layout(cfg: dict) -> dict:
    """``{path: (shape, kind)}`` of every parameter leaf; ``kind`` is
    ``matrix`` (fan-in scaled normal), ``norm`` (1 + a small normal) or
    ``bias`` (a small normal)."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hq, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   head_dim(cfg))
    f, vp = cfg["intermediate_size"], vocab_padded(cfg)
    out = {"embed.tok": ((vp, d), "matrix"),
           "layers.ln1.w": ((L, d), "norm"),
           "layers.ln2.w": ((L, d), "norm"),
           "layers.attn.wq": ((L, d, hq * hd), "matrix"),
           "layers.attn.wk": ((L, d, hkv * hd), "matrix"),
           "layers.attn.wv": ((L, d, hkv * hd), "matrix"),
           "layers.attn.wo": ((L, hq * hd, d), "matrix"),
           "ln_f.w": ((d,), "norm")}
    if not cfg["tie_word_embeddings"]:
        out["embed.unembed"] = ((d, vp), "matrix")
    if cfg["qkv_bias"]:
        out.update({"layers.attn.bq": ((L, hq * hd), "bias"),
                    "layers.attn.bk": ((L, hkv * hd), "bias"),
                    "layers.attn.bv": ((L, hkv * hd), "bias")})
    if cfg["qk_norm"] is not None:
        out.update({"layers.attn.qn": ((L, hd), "norm"),
                    "layers.attn.kn": ((L, hd), "norm")})
    if cfg["family"] == "moe":
        e = cfg["num_experts"]
        out.update({"layers.moe.router": ((L, d, e), "matrix"),
                    "layers.moe.wg": ((L, e, d, f), "matrix"),
                    "layers.moe.wu": ((L, e, d, f), "matrix"),
                    "layers.moe.wd": ((L, e, f, d), "matrix")})
    else:
        out.update({"layers.mlp.wg": ((L, d, f), "matrix"),
                    "layers.mlp.wu": ((L, d, f), "matrix"),
                    "layers.mlp.wd": ((L, f, d), "matrix")})
    return out


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """``{path: tensor}`` from ``seed``, drawn on ``device`` by a
    ``torch.Generator`` there, leaves in sorted order, in the served
    dtype.  A matrix is a normal over the square root of its fan-in (the
    port's own scale, ``params.init``); norms are 1 + 0.1 N and biases
    0.1 N, so that the reference's check reaches them."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    dtype = DTYPES[cfg["torch_dtype"]]
    out = {}
    for path, (shape, kind) in sorted(layout(cfg).items()):
        t = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        if kind == "matrix":
            t.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "norm":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.1)
        out[path] = t
    return out


def as_tree(flat: dict) -> dict:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}`` (the port's params)."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, p + "."))
        else:
            out[p] = v
    return out


def check_layout(cfg: dict, zoo) -> None:
    """Raise unless the port's parameter spec has exactly this layout."""
    spec = flatten(zoo.spec())
    want = {p: s for p, (s, _) in layout(cfg).items()}
    have = {p: tuple(s.shape) for p, s in spec.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))
        raise ValueError(f"{cfg['name']}: the port's parameters differ from "
                         f"the benchmark's layout: {diff[:6]}")


def n_matmul_params(cfg: dict) -> int:
    """Parameters of every matrix that multiplies activations for one
    token, the output head included (tied or not); a MoE layer counts its
    top-k experts and its router.  Norms, biases and the embedding lookup
    are not products."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hq, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   head_dim(cfg))
    f = cfg["intermediate_size"]
    attn = d * (hq + 2 * hkv) * hd + hq * hd * d
    if cfg["family"] == "moe":
        ff = cfg["num_experts_per_tok"] * 3 * d * f + d * cfg["num_experts"]
    else:
        ff = 3 * d * f
    return L * (attn + ff) + d * cfg["vocab_size"]
