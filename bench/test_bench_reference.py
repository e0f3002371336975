"""The plain references at a tiny size on the CPU, against the equations
written out here one position and one head at a time (float64)."""
from __future__ import annotations

import math

import pytest
import torch

from bench import model, spec
from bench.reference import dense, moe
from bench.reference import train as ref_train
from bench.reference.common import Precision

TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, head_dim=8, intermediate_size=48,
            vocab_size=61, pad_vocab_to=8, torch_dtype="float32")


def _cfg(name, **kw):
    return {**spec.config(name), **TINY, **kw}


def _rms(x, w, eps):
    return x / math.sqrt(sum(v * v for v in x.tolist()) / len(x) + eps) * w


def _rope(x, pos, theta):
    half = len(x) // 2
    out = x.clone()
    for i in range(half):
        a = pos * theta ** (-i / half)
        out[i] = x[i] * math.cos(a) - x[i + half] * math.sin(a)
        out[i + half] = x[i + half] * math.cos(a) + x[i] * math.sin(a)
    return out


def _naive_logits(w, cfg, tokens, ff):
    """Every position's logits by the equations, float64."""
    w = {k: t.double() for k, t in w.items()}
    eps, hq, hkv = (cfg["rms_norm_eps"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"])
    hd, theta, s = cfg["head_dim"], cfg["rope_theta"], len(tokens)
    xs = [w["embed.tok"][t] for t in tokens]
    for i in range(cfg["num_hidden_layers"]):
        lw = {k[len("layers."):]: v[i] for k, v in w.items()
              if k.startswith("layers.")}
        qs, ks, vs = [], [], []
        for p, x in enumerate(xs):
            h = _rms(x, lw["ln1.w"], eps)
            q, k, v = h @ lw["attn.wq"], h @ lw["attn.wk"], h @ lw["attn.wv"]
            if cfg["qkv_bias"]:
                q, k, v = q + lw["attn.bq"], k + lw["attn.bk"], v + lw["attn.bv"]
            q, k, v = q.view(hq, hd), k.view(hkv, hd), v.view(hkv, hd)
            if cfg["qk_norm"]:
                q = torch.stack([_rms(r, lw["attn.qn"], eps) for r in q])
                k = torch.stack([_rms(r, lw["attn.kn"], eps) for r in k])
            qs.append(torch.stack([_rope(r, p, theta) for r in q]))
            ks.append(torch.stack([_rope(r, p, theta) for r in k]))
            vs.append(v)
        new = []
        for p, x in enumerate(xs):
            heads = []
            for h in range(hq):
                g = h // (hq // hkv)
                sc = [float(qs[p][h] @ ks[j][g]) / math.sqrt(hd)
                      for j in range(p + 1)]
                m = max(sc)
                e = [math.exp(a - m) for a in sc]
                heads.append(sum(e[j] / sum(e) * vs[j][g]
                                 for j in range(p + 1)))
            new.append(x + torch.cat(heads) @ lw["attn.wo"])
        xs = new
        xs = ff(xs, lw, cfg)
    head = w["embed.tok"][:cfg["vocab_size"]].T \
        if cfg["tie_word_embeddings"] else w["embed.unembed"][:, :cfg["vocab_size"]]
    return torch.stack([_rms(x, w["ln_f.w"], eps) @ head for x in xs])


def _swiglu(x, wg, wu, wd):
    a = x @ wg
    return (a / (1 + torch.exp(-a)) * (x @ wu)) @ wd


def _dense_ff(xs, lw, cfg):
    return [x + _swiglu(_rms(x, lw["ln2.w"], cfg["rms_norm_eps"]),
                        lw["mlp.wg"], lw["mlp.wu"], lw["mlp.wd"]) for x in xs]


def _moe_ff(prompt_len):
    def ff(xs, lw, cfg):
        e_n, k = cfg["num_experts"], cfg["num_experts_per_tok"]
        c = int(prompt_len * k * cfg["capacity_factor"] / e_n)
        m = cfg["capacity_multiple"]
        cap = max(cfg["capacity_min"], -(-c // m) * m)
        taken = [0] * e_n
        out = []
        for p, x in enumerate(xs):
            h = _rms(x, lw["ln2.w"], cfg["rms_norm_eps"])
            probs = torch.softmax(h @ lw["moe.router"], -1).tolist()
            top = sorted(range(e_n), key=lambda e: (-probs[e], e))[:k]
            total = sum(probs[e] for e in top)
            y = torch.zeros_like(x)
            for e in top:
                if p < prompt_len:           # the prefill's group
                    taken[e] += 1
                    if taken[e] > cap:
                        continue
                y = y + probs[e] / total * _swiglu(
                    h, lw["moe.wg"][e], lw["moe.wu"][e], lw["moe.wd"][e])
            out.append(x + y)
        return out
    return ff


def test_dense_reference_is_the_equations():
    cfg = _cfg("qwen2-0.5b")
    w = model.draw_weights(cfg, 11, "cpu")
    toks = torch.tensor([5, 17, 3, 60, 2, 9, 44])
    at = torch.arange(7)
    got = dense.logits_at(w, cfg, toks, at)
    want = _naive_logits(w, cfg, toks.tolist(), _dense_ff)
    assert got.shape == (7, 61)
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-5)


def test_moe_reference_is_the_equations_capacity_included():
    # 4 experts, top 2, capacity int(6 x 2 x 0.5 / 4) = 1: the prompt's
    # later assignments drop, the decoded tokens' never do
    cfg = _cfg("olmoe-1b-7b", num_key_value_heads=4, num_experts=4,
               num_experts_per_tok=2, capacity_factor=0.5,
               capacity_multiple=1, capacity_min=1)
    w = model.draw_weights(cfg, 12, "cpu")
    toks = torch.tensor([5, 17, 3, 60, 2, 9, 44, 8])
    got = moe.logits_at(w, cfg, toks, torch.arange(8), prompt_len=6)
    want = _naive_logits(w, cfg, toks.tolist(), _moe_ff(6))
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-5)
    dropped = ~moe.kept(torch.tensor([[0, 1], [0, 2], [1, 3]]), cfg, 3)
    assert dropped.tolist() == [[False, False], [True, False], [True, False]]


def test_loss_is_the_mean_next_token_xent():
    cfg = _cfg("qwen2-0.5b")
    w = model.draw_weights(cfg, 13, "cpu")
    toks = torch.tensor([[5, 17, 3, 60, 2], [9, 44, 8, 1, 0]])
    got = dense.loss({k: t.float() for k, t in w.items()}, cfg, toks, chunk=3)
    nll = []
    for row in toks.tolist():
        lg = _naive_logits(w, cfg, row, _dense_ff)
        nll += [float(torch.logsumexp(lg[p], 0) - lg[p, row[p + 1]])
                for p in range(len(row) - 1)]
    assert float(got) == pytest.approx(sum(nll) / len(nll), rel=1e-5)


def test_schedule_and_one_adamw_step_by_hand():
    opt = {"lr": 1e-2, "warmup_steps": 2, "total_steps": 12, "b1": 0.9,
           "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1e9}
    assert ref_train.lr_at(opt, 0) == pytest.approx(5e-3)
    assert ref_train.lr_at(opt, 7) == pytest.approx(
        1e-2 * 0.5 * (1 + math.cos(math.pi * 0.5)))
    cfg = _cfg("qwen2-0.5b")
    w = model.draw_weights(cfg, 14, "cpu")
    toks = torch.tensor([[5, 17, 3, 60, 2, 9]])
    got = ref_train.follow(w, cfg, [toks], opt, "cpu")
    leaves = {k: t.detach().requires_grad_() for k, t in w.items()}
    grads = torch.autograd.grad(dense.loss(leaves, cfg, toks),
                                list(leaves.values()))
    for (k, p), g in zip(w.items(), grads):
        # first step: m^ = g, v^ = g^2, so the update is g / (|g| + eps)
        step = 5e-3 * (g / (g.abs() + 1e-8) + 0.1 * p)
        assert got["grad"][k] == pytest.approx(float(g.norm()), rel=1e-5)
        assert got["change"][k] == pytest.approx(float(step.norm()),
                                                 rel=1e-4)


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 448.0, -3.3]])
    q = Precision("fp8").mm(x, torch.eye(4))
    # per-row scale 1: e4m3 keeps 3 mantissa bits (1.0625 -> 1.0)
    assert q.tolist()[0][:3] == [1.0, 1.0, 448.0]
    assert abs(q[0, 3] + 3.3) <= 0.125 + 1e-6
