"""Plain float32 reference of the dense decoder (qwen2-0.5b): the logits of
a served sequence, and the training loss for autograd."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import (F32, Precision, attention_block, head_weight,
                     layer_weights, rms_norm, swiglu)


def _layer(x, lw: dict, cfg: dict, positions, prec: Precision):
    eps = cfg["rms_norm_eps"]
    x = x + attention_block(rms_norm(x, lw["ln1.w"], eps), lw, cfg,
                            positions, prec)
    return x + swiglu(rms_norm(x, lw["ln2.w"], eps), lw["mlp.wg"],
                      lw["mlp.wu"], lw["mlp.wd"], prec)


@torch.no_grad()
def logits_at(w: dict, cfg: dict, tokens: torch.Tensor, at: torch.Tensor,
              prec: Precision = Precision(), prompt_len: int = 0):
    """float32 logits [len(at), vocab] at positions ``at`` of the sequence
    ``tokens`` [S] (batch 1, positions 0..S-1).  ``prompt_len`` is unused
    here (no layer of this family groups tokens)."""
    s = tokens.shape[0]
    positions = torch.arange(s, device=tokens.device)
    x = w["embed.tok"][tokens.long()].to(F32)[None]
    for i in range(cfg["num_hidden_layers"]):
        x = _layer(x, layer_weights(w, i), cfg, positions, prec)
    x = rms_norm(x[0, at], w["ln_f.w"].to(F32), cfg["rms_norm_eps"])
    return prec.mm(x, head_weight(w, cfg))


def _xent_chunk(x, head, labels, prec: Precision):
    lg = prec.mm(x, head)
    return (torch.logsumexp(lg, -1)
            - lg.gather(-1, labels[..., None])[..., 0]).sum()


def loss(params: dict, cfg: dict, tokens: torch.Tensor,
         prec: Precision = Precision(), chunk: int = 256):
    """Mean next-token cross-entropy of ``tokens`` [B, S] over the real
    vocabulary; ``params`` are float32 leaves (``{path: tensor}``) that
    may require grad.  Each layer and each chunk of the loss is recomputed
    in the backward (``checkpoint``), so that 4 x 4096 tokens fit."""
    b, s = tokens.shape
    eps = cfg["rms_norm_eps"]
    positions = torch.arange(s, device=tokens.device)
    x = F.embedding(tokens.long(), params["embed.tok"])
    per_layer = {p[len("layers."):]: t.unbind(0) for p, t in params.items()
                 if p.startswith("layers.")}
    for i in range(cfg["num_hidden_layers"]):
        lw = {p: t[i] for p, t in per_layer.items()}
        x = checkpoint(_layer, x, lw, cfg, positions, prec,
                       use_reentrant=False)
    x = rms_norm(x, params["ln_f.w"], eps)
    v = cfg["vocab_size"]
    head = params["embed.tok"][:v].T if cfg["tie_word_embeddings"] \
        else params["embed.unembed"][:, :v]
    labels = tokens[:, 1:].long()
    total = torch.zeros((), dtype=F32, device=tokens.device)
    for lo in range(0, s - 1, chunk):
        hi = min(s - 1, lo + chunk)
        total = total + checkpoint(_xent_chunk, x[:, lo:hi], head,
                                   labels[:, lo:hi], prec,
                                   use_reentrant=False)
    return total / (b * (s - 1))
