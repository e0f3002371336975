"""The models run sharded for real: four CPU processes over gloo hold each
step on ``DTensor``s to the same step on plain tensors in one process.

Each rank runs, for four reduced families in float32, one train step
(``dryrun.build_train_step``: loss, grads, AdamW), one prefill and two
decode steps, the arguments laid out by the production sharding rules
(``dryrun.lay_out``) and each call made as the dry-run makes it
(``dryrun.call_sharded``: under ``set_act_mesh``, the outputs laid out by
their ``out_shardings``).  starcoder2-7b runs on a 1x4 mesh, where its 6
heads of 12 do not divide the model axis (the attention's batch reshard)
and 72 = 4 x 18 splits a head (the redistribution before the head view);
olmoe-1b-7b, falcon-mamba-7b and recurrentgemma-9b on a 2x2 mesh.  The
loss, the grad norm and the logits of the prefill and of each decode step
must be within 1e-5 of the plain ones, relative to the largest plain
magnitude; every updated parameter (``full_tensor()``) within 1e-5 of
max(1, |plain|) element by element (a gradient that is zero but for
rounding, as a key bias's, moves its parameter by +-lr whatever its sign
of noise, and the biases start at zero).  The ranks run with ``jax`` and
the JAX package made unimportable.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = {"starcoder2-7b": (1, 4), "olmoe-1b-7b": (2, 2),
          "falcon-mamba-7b": (2, 2), "recurrentgemma-9b": (2, 2)}
RTOL = 1e-5

RANK = textwrap.dedent("""
    import dataclasses, json, sys
    for name in ("jax", "jaxlib", "repro"):     # the port runs alone
        sys.modules[name] = None
    import torch
    import torch.distributed as dist
    rank, store_path, meshes = int(sys.argv[1]), sys.argv[2], json.loads(
        sys.argv[3])
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                            rank=rank, world_size=4)
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import leaves
    from repro_torch.models.zoo import get_model
    from repro_torch.optim import adamw

    def full(t):
        return t.full_tensor() if sh.is_dtensor(t) else t

    def rel(got, want):
        got, want = full(got).double(), want.double()
        return float((got - want).abs().max()
                     / want.abs().max().clamp_min(1e-30))

    def rel1(got, want):    # elementwise, of max(1, |want|)
        got, want = full(got).double(), want.double()
        return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())

    out = {}
    for arch, (data, model) in meshes.items():
        cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
        zoo = get_model(cfg)
        mesh = make_host_mesh(data, model, device="cpu")
        params = zoo.init_params(0, device="cpu")
        ps = sh.param_shardings(zoo.spec(), mesh)
        rep = sh.replicated(mesh)
        err = {}

        # one train step
        batch = zoo.make_batch(ShapeConfig("t", 16, 8, "train"), seed=1,
                               device="cpu")
        state = adamw.init_state(params)
        os_ = {"m": sh.zero_shardings(zoo.spec(), mesh),
               "v": sh.zero_shardings(zoo.spec(), mesh), "step": rep}
        bs = sh.batch_shardings(batch, mesh)
        step = dryrun.build_train_step(zoo)
        wp, _, wm = step(params, state, batch)
        gp, _, gm = dryrun.call_sharded(
            step, dryrun.lay_out((params, state, batch), (ps, os_, bs)),
            (ps, os_, rep), mesh)
        err["loss"] = rel(gm["loss"], wm["loss"])
        err["grad_norm"] = rel(gm["grad_norm"], wm["grad_norm"])
        err["params"] = max(rel1(g, w) for g, w in zip(leaves(gp),
                                                       leaves(wp)))

        # one prefill, then two decode steps on the plain route's tokens
        s, max_len = 16, 18
        batch = zoo.make_batch(ShapeConfig("p", s, 8, "prefill"), seed=2,
                               device="cpu")
        wl, wc, wpos = zoo.prefill(params, batch, max_len)
        cs = sh.cache_shardings(wc, mesh)
        pos_s = sh.batch_shardings({"position": wpos}, mesh)["position"]
        dp = dryrun.lay_out(params, ps)
        gl, gc, gpos = dryrun.call_sharded(
            lambda p, b: zoo.prefill(p, b, max_len),
            (dp, dryrun.lay_out(batch, sh.batch_shardings(batch, mesh))),
            (rep, cs, pos_s), mesh)
        assert sh.is_dtensor(gl) and sh.is_dtensor(gc["h" if "h" in gc
                                                     else next(iter(gc))])
        err["prefill"] = rel(gl, wl)
        for i in range(2):
            tok = wl[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            tok_s = sh.batch_shardings({"token": tok}, mesh)["token"]
            wl, wc, wpos = zoo.decode_step(params, tok, wc, wpos)
            gl, gc, gpos = dryrun.call_sharded(
                zoo.decode_step,
                dryrun.lay_out((dp, tok, gc, gpos), (ps, tok_s, cs, pos_s)),
                (rep, cs, pos_s), mesh)
            err[f"decode{i}"] = rel(gl, wl)
        out[arch] = err
    if rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()
""")


def test_sharded_steps_match_plain_steps(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(tmp_path / "store"),
         json.dumps(MESHES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    errs = json.loads(outs[0][0].splitlines()[-1])
    assert set(errs) == set(MESHES)
    for arch, err in errs.items():
        assert set(err) == {"loss", "grad_norm", "params", "prefill",
                            "decode0", "decode1"}, arch
        for k, e in err.items():
            assert e <= RTOL, (arch, k, e)
