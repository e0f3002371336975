"""The two recurrence kernels' tiles, held here on the CPU: a float32 model
of ``ssm_scan``'s arithmetic order, the launch plans of both wrappers, and
``rg_lru_plain`` against the reference kernel at the ring's edges.

``csrc/ssm_scan.cu`` gives each channel ``lanes`` threads of ``states``
state elements (state ``n = k * lanes + lane``), buffers each lane's
partial sum over its states for ``lanes`` steps and then adds the lanes'
partials by a reduce-scatter whose order is a tree of halves; it takes
exp(dt * a) as one ex2 of dt times a * log2(e); it walks the sequence in
stages of ``CHUNK`` steps and pads the last buffer with zero steps
(dt = x = b = 0), which must leave h as it is.  The kernel cannot run
here, so ``_ssm_tile_model`` repeats that order in float32 torch, step by
step and tile by tile, and is held against the reference's Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it) and the float64
oracle at ``SSM_TOL``, the tolerance the card holds the kernel to against
its plain version: 2e-5 of the largest |value| (float32 rounding in
another order: the sum over n, the exponential, and in the kernel FMA
contraction).

``csrc/rg_lru.cu`` rounds each step's product and then its sum, as
``rg_lru_plain`` does, and is held to it bit for bit on the card; here
``rg_lru_plain`` is held bit for bit to the reference kernel in interpret
mode at the edges of the kernel's ring of stages (``STEPS`` and
``STAGES`` by block width).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_oracle
from repro.kernels import ssm_scan as ref_scan
from repro_torch.kernels import rg_lru as rg
from repro_torch.kernels import ssm_scan as sc

ROOT = Path(__file__).resolve().parents[1]
SSM_TOL = 2e-5
LOG2E = torch.tensor(1.44269502, dtype=torch.float32)
SMS = 132
SSM_PATHS = ((1, 8192, 16), (4, 8192, 16))       # (B, Di, N): 512 / 4096
RG_PATHS = ((1, 4096), (4, 4096))                # (B, D): 512 / 4096 steps


def _ssm_inputs(seed, bsz, s, di, n, zero_h0):
    """x, dt (softplus of a normal), a (< 0), b, c, d, h0, float32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((bsz, s, di)).astype(f),
            np.log1p(np.exp(rng.standard_normal((bsz, s, di)))).astype(f),
            -np.exp(0.5 * rng.standard_normal((di, n))).astype(f),
            rng.standard_normal((bsz, s, n)).astype(f),
            rng.standard_normal((bsz, s, n)).astype(f),
            rng.standard_normal(di).astype(f),
            (np.zeros((bsz, di, n)) if zero_h0
             else rng.standard_normal((bsz, di, n))).astype(f))


def _ssm_tile_model(x, dt, a, b, c, d, h0, lanes, states):
    """The kernel's arithmetic in float32: states padded to lanes * states
    (zeros), state n = k * lanes + lane; a step's decay is 2^(dt * a2)
    with a2 = a * log2(e) in float32 (the kernel's ex2; torch's exp2 stands
    in for the special-function unit), every state updates, each lane sums
    its states' h * c in k order; per buffer of ``lanes`` steps (zero steps
    past S) the lanes' partials add as a tree of halves, then
    y = that + d * x."""
    bsz, s, di = x.shape
    n, pad = a.shape[1], lanes * states
    a = torch.nn.functional.pad(a, (0, pad - n))
    a2 = a * LOG2E                      # exp(dt * a) = 2^(dt * a2)
    b = torch.nn.functional.pad(b, (0, pad - n))
    c = torch.nn.functional.pad(c, (0, pad - n))
    h = torch.nn.functional.pad(h0, (0, pad - n))
    zero_n, zero_d = torch.zeros(bsz, pad), torch.zeros(bsz, di)
    y = torch.empty_like(x)
    for t0 in range(0, s, sc.CHUNK):
        steps = min(sc.CHUNK, s - t0)
        for g in range(0, steps, lanes):
            parts = []
            for j in range(lanes):
                t = t0 + g + j
                live = t < s
                dtt, xt = (dt[:, t], x[:, t]) if live else (zero_d, zero_d)
                bt, ct = (b[:, t], c[:, t]) if live else (zero_n, zero_n)
                da = torch.exp2(dtt[..., None] * a2)
                new = da * h + (dtt * xt)[..., None] * bt[:, None, :]
                if not live:
                    assert torch.equal(new, h), "a zero step moved h"
                h = new
                hc = (h * ct[:, None, :]).view(bsz, di, states, lanes)
                p = hc[:, :, 0]
                for k in range(1, states):
                    p = p + hc[:, :, k]
                parts.append(p)
            v = torch.stack(parts)              # [step, B, Di, lane]
            while v.shape[-1] > 1:
                half = v.shape[-1] // 2
                v = v[..., :half] + v[..., half:]
            for j in range(lanes):
                if t0 + g + j < s:
                    y[:, t0 + g + j] = v[j, ..., 0] + d * x[:, t0 + g + j]
    return y, h[..., :n]


def _within(got, want, what):
    for g, w in zip(got, want):
        w = torch.as_tensor(np.asarray(w, np.float64))
        assert g.shape == w.shape, what
        err = float((g.double() - w).abs().max())
        assert err <= SSM_TOL * float(w.abs().max()), (what, err)


def _divisor(s, most=64):
    return max(k for k in range(1, min(s, most) + 1) if s % k == 0)


S_KINDS = ("1", "G-1", "G", "G+1", "63", "64", "65", "200")


@pytest.mark.parametrize("n", (1, 5, 16, 32))
@pytest.mark.parametrize("kind", S_KINDS)
def test_ssm_tile_model_matches_reference(kind, n):
    """The model at N's plan, across its buffer of G = lanes steps and its
    stage of CHUNK steps, ragged Di (44: no whole block of 8, 16 or 32
    channels), zero and random h0: within SSM_TOL of the reference's
    Pallas kernel (interpret mode), of the float64 oracle and of the plain
    version the card holds the kernel to."""
    p = sc.plan(1, 44, n)
    g = p.lanes
    s = {"1": 1, "G-1": g - 1, "G": g, "G+1": g + 1}.get(kind) or int(kind)
    zero_h0 = S_KINDS.index(kind) % 2 == 0
    inputs = _ssm_inputs(S_KINDS.index(kind) * 40 + n, 2, s, 44, n, zero_h0)
    ins = [torch.from_numpy(t) for t in inputs]
    got = _ssm_tile_model(*ins, p.lanes, p.states)
    want = ref_scan.ssm_scan(*[jnp.asarray(t) for t in inputs],
                             chunk=_divisor(s), block_d=44)
    _within(got, want, "reference kernel")
    _within(got, ref_oracle.ssm_scan_ref(*inputs), "float64 oracle")
    _within(got, sc.ssm_scan_plain(*ins), "plain")


@pytest.mark.parametrize("lanes,states", sc.INSTANCES)
def test_ssm_tile_model_every_instance(lanes, states):
    """Each instance the library holds, at the largest N it takes and at
    N 1, over two stages and a ragged tail: within SSM_TOL of the oracle."""
    for n in sorted({1, min(lanes * states, sc.MAX_STATE)}):
        inputs = _ssm_inputs(lanes * 10 + states + n, 1, sc.CHUNK + 5, 12,
                             n, n == 1)
        got = _ssm_tile_model(*[torch.from_numpy(t) for t in inputs], lanes,
                              states)
        _within(got, ref_oracle.ssm_scan_ref(*inputs), (lanes, states, n))


def test_ssm_plan_covers_every_n():
    """Every N in 1..32 gets an instance with room for its states; every
    instance fits a block's shared memory and tiles its stage; N outside
    1..32 and an instance the library lacks are refused."""
    for n in range(1, sc.MAX_STATE + 1):
        p = sc.plan(1, 100, n)
        assert (p.lanes, p.states) in sc.INSTANCES
        assert p.lanes * p.states >= n
        assert p.lanes * p.channels == sc.BLOCK
        assert p.blocks == -(-100 // p.channels)
    for lanes, states in sc.INSTANCES:
        assert sc.smem_bytes(lanes, states) <= sc.SMEM_LIMIT
        assert sc.CHUNK % lanes == 0 and lanes & (lanes - 1) == 0
        assert (sc.BLOCK // lanes) % 8 == 0 and lanes * states % 8 == 0
        assert sc.ROW % 4 == 0 and sc.ROW % 32 == 4    # 16-byte rows, and 8
        # consecutive rows in distinct banks
    for bad in (0, 33):
        with pytest.raises(ValueError, match=f"N = {bad}"):
            sc.plan(1, 8, bad)
    with pytest.raises(ValueError, match="no instance"):
        sc.plan(1, 8, 16, lanes=8, states=1)
    with pytest.raises(ValueError, match="no instance"):
        sc.plan(1, 8, 4, lanes=2, states=2)


@pytest.mark.parametrize("bsz,di,n", SSM_PATHS)
def test_ssm_plan_fills_the_card_at_the_path_shapes(bsz, di, n):
    p = sc.plan(bsz, di, n)
    assert p.blocks >= SMS
    assert p.smem_bytes == sc.smem_bytes(p.lanes, p.states) <= sc.SMEM_LIMIT


def test_rg_lru_plan():
    """The widest block (32, 16, 8 or 4 channels) that gives the grid 3
    blocks an SM; the ring fits a block's shared memory; at both path
    shapes the grid covers every SM and each SM keeps at least 16 KB of
    loads in flight."""
    for bsz, d, want in ((1, 4096, 8), (4, 4096, 32), (5, 1, 4),
                         (1, 3 * 32 * SMS, 32), (1, 3 * 32 * SMS - 32, 16),
                         (3, 163, 4)):
        assert rg.plan(bsz, d).width == want, (bsz, d)
    for width in rg.WIDTHS:
        assert width % 4 == 0 and width <= 32
        assert rg.smem_bytes(width) <= rg.SMEM_LIMIT
        assert rg.STAGES[width] >= 2 and rg.STEPS[width] % 8 == 0
    for bsz, d in RG_PATHS:
        p = rg.plan(bsz, d)
        assert p.blocks >= SMS
        assert p.in_flight_bytes * (p.blocks // SMS) >= 16 * 1024


def _rg_inputs(seed, bsz, s, d, zero_h0):
    """a in [0, 1), b ~ 0.1 N(0, 1), as the reference's kernel tests."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.random((bsz, s, d)).astype(f),
            (0.1 * rng.standard_normal((bsz, s, d))).astype(f),
            (np.zeros((bsz, d)) if zero_h0
             else rng.standard_normal((bsz, d))).astype(f))


RG_EDGE_S = tuple(sorted({
    s for w in rg.WIDTHS
    for s in (rg.STEPS[w] - 1, rg.STEPS[w], rg.STEPS[w] + 1,
              (rg.STAGES[w] - 1) * rg.STEPS[w],
              (rg.STAGES[w] - 1) * rg.STEPS[w] + 1,
              rg.STAGES[w] * rg.STEPS[w] + 1)}))
RG_EDGE_D = (8, 17, 33)

# The reference kernel over every case of an .npz, in a process of its own:
# where the CPU has FMA instructions, XLA's CPU compiler contracts the step
# a * h + b into one fused multiply-add (one rounding, not the two the
# kernel's source writes); capped below them (--xla_cpu_max_isa=SSE4_2, read
# once a process) it rounds the product and then the sum, as written.
_REF_RG = textwrap.dedent("""\
    import sys
    import jax.numpy as jnp
    import numpy as np
    from repro.kernels import rg_lru as ref_rg
    ins = np.load(sys.argv[1])
    out = {}
    for key in sorted({k.split(":")[0] for k in ins.files}):
        s, d = map(int, key.split("_"))
        chunk = max(k for k in range(1, min(s, 128) + 1) if s % k == 0)
        args = [jnp.asarray(ins[f"{key}:{i}"]) for i in range(3)]
        y, h = ref_rg.rg_lru(*args, chunk=chunk, block_d=d)
        out[f"{key}:y"], out[f"{key}:h"] = np.asarray(y), np.asarray(h)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def rg_reference(tmp_path_factory):
    """{(s, d): (inputs, reference y, reference hT)} at every edge case."""
    tmp = tmp_path_factory.mktemp("rg_ref")
    cases = {(s, d): _rg_inputs(s * 100 + d, 2, s, d, s % 2 == 0)
             for s in RG_EDGE_S for d in RG_EDGE_D}
    np.savez(tmp / "in.npz", **{f"{s}_{d}:{i}": t
                                for (s, d), ins in cases.items()
                                for i, t in enumerate(ins)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_cpu_max_isa=SSE4_2").strip())
    out = subprocess.run([sys.executable, "-c", _REF_RG, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    got = np.load(tmp / "out.npz")
    return {k: (ins, got[f"{k[0]}_{k[1]}:y"], got[f"{k[0]}_{k[1]}:h"])
            for k, ins in cases.items()}


@pytest.mark.parametrize("s", RG_EDGE_S)
@pytest.mark.parametrize("d", RG_EDGE_D)
def test_rg_lru_plain_is_the_reference_kernel_bit_for_bit(rg_reference, s,
                                                          d):
    """At the ring's edges of every width (a stage of its steps, the
    prologue's stages - 1 tiles, the whole ring) and the widths' block
    edges,
    ``rg_lru_plain`` (what the card holds the kernel to with
    ``torch.equal``) equals the reference's Pallas kernel in interpret
    mode bit for bit: each step rounds a product and then a sum."""
    ins, wy, wh = rg_reference[(s, d)]
    y, h = rg.rg_lru_plain(*[torch.from_numpy(t) for t in ins])
    assert torch.equal(y, torch.from_numpy(wy))
    assert torch.equal(h, torch.from_numpy(wh))
