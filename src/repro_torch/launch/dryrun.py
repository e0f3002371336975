"""Multi-pod dry-run: trace every (architecture × input shape) on the
production meshes, on the ``meta`` device, and extract the roofline raw
material.  It touches no device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``main`` first initialises a ``"fake"`` process group of the mesh's size
(256 or 512 ranks, this process rank 0; no communication happens), as the
reference sets ``XLA_FLAGS`` for 512 host devices first, and destroys it
after each mesh.  Per cell this writes
``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json`` with:
  * ``memory_analysis``: per-device argument and output bytes, summed from
    each leaf's shard (``distribute_tensor`` of the meta leaf by its
    sharding, then ``to_local()``);
  * ``traced_flops``: the step's FLOPs at global shapes
    (``torch.utils.flop_counter.FlopCounterMode`` over the traced step,
    under ``set_act_mesh(mesh)``, so the attention reshard branch is the
    one the mesh picks), and ``roofline.compute_s`` from them;
  * the analytic ``model_flops`` and ``tokens``, as the reference;
  * ``departures``: the reference's keys that have no counterpart without
    a compiled, partitioned program.

A leaf whose sharding cannot be laid out (an axis the mesh lacks, a dim
that does not divide) fails its cell: that is a sharding bug, as a failed
``.lower().compile()`` is in the reference.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._pytree import tree_leaves as tree_leaves_any
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, get_config
from ..configs.base import SHAPES, cells_for
from ..distributed import sharding as sh
from ..models import transformer as _T
from ..models.params import leaves, unflatten
from ..models.zoo import get_model
from ..optim import adamw
from .mesh import make_production_mesh
from .train import loss_and_grads

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")

# NVIDIA H100 80GB HBM3, dense bf16 tensor-core peak at a 700 W power limit
# (NVIDIA's data sheet, SXM part), per device
PEAK_FLOPS = 989e12
HBM_BYTES = 80e9             # the same card's memory ("80 GB")

MESH_RANKS = {"single": 256, "multi": 512}

# the reference's keys that need a compiled, partitioned program
DEPARTURES = [
    {"key": "memory_analysis.temp_size_in_bytes",
     "why": "XLA's buffer assignment of the compiled program; an eager "
            "PyTorch step has no such plan"},
    {"key": "memory_analysis.generated_code_size_in_bytes",
     "why": "no compiled program"},
    {"key": "hlo_bytes, roofline.memory_s",
     "why": "XLA's bytes accessed by the fused program; meta tracing "
            "counts no fusion"},
    {"key": "collective_bytes, roofline.collective_s, _collective_bytes",
     "why": "the collectives of the SPMD-partitioned HLO; the step is "
            "traced at global shapes, not run sharded"},
    {"key": "memory_analysis.output_size_in_bytes (in part)",
     "why": "XLA's also counts the output tuple's index table, 8 bytes an "
            "output leaf; the port's is the outputs' shards alone"},
    {"key": "cost_analysis, hlo_size_chars", "why": "no HLO"},
    {"key": "lower_s, compile_s", "why": "trace_s in their place"},
    {"key": "hlo_flops", "why": "traced_flops in its place"},
]


def _opt_cfg():
    return adamw.OptConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)


def build_train_step(zoo, impl: str = "chunked", microbatch: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr", "grad_norm"})``: loss and grads
    (``launch.train.loss_and_grads``), then ``adamw.apply``.  With
    ``microbatch`` > 1 the batch splits along dim 0; grads accumulate in
    float32 in microbatch order and, like the loss, are divided by the
    count."""
    ocfg = _opt_cfg()

    def train_step(params, opt_state, batch):
        if microbatch > 1:
            split = {k: t.reshape((microbatch, t.shape[0] // microbatch)
                                  + tuple(t.shape[1:]))
                     for k, t in batch.items()}
            loss = None
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves(params)]
            for i in range(microbatch):
                li, g = loss_and_grads(zoo, params,
                                       {k: t[i] for k, t in split.items()},
                                       impl)
                acc = [a + b.to(torch.float32)
                       for a, b in zip(acc, leaves(g))]
                loss = li if loss is None else loss + li
            loss = loss / microbatch
            grads = unflatten(params, [a / microbatch for a in acc])
        else:
            loss, grads = loss_and_grads(zoo, params, batch, impl)
        params, opt_state, metrics = adamw.apply(params, grads, opt_state,
                                                 ocfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def build_prefill_step(zoo, max_len: int, impl: str = "chunked"):
    def prefill_step(params, batch):
        return zoo.prefill(params, batch, max_len, impl=impl)
    return prefill_step


def build_serve_step(zoo):
    def serve_step(params, token, cache, position):
        return zoo.decode_step(params, token, cache, position)
    return serve_step


def _abstract_batch(zoo, shape) -> dict:
    meta = torch.device("meta")
    return {k: torch.empty(s, dtype=dt, device=meta)
            for k, (s, dt) in zoo.batch_specs(shape).items()}


def cell_program(arch: str, shape_name: str, mesh, impl: str = "chunked",
                 microbatch: int = 1, kv_int8: bool = False):
    """One cell's step at global shapes: ``(fn, args, in_shardings,
    out_shardings)``, the arguments as meta tensors, each sharding tree of
    the structure of ``args`` (a tuple) or of ``fn``'s result."""
    cfg = get_config(arch)
    zoo = get_model(cfg)
    shape = SHAPES[shape_name]
    pspec = zoo.spec()
    params_abs = zoo.abstract_params()
    params_shard = sh.param_shardings(pspec, mesh)
    rep = sh.replicated(mesh)

    if shape.kind == "train":
        opt_abs = adamw.abstract_state(params_abs)
        opt_shard = {"m": sh.zero_shardings(pspec, mesh),
                     "v": sh.zero_shardings(pspec, mesh), "step": rep}
        batch_abs = _abstract_batch(zoo, shape)
        batch_shard = sh.batch_shardings(batch_abs, mesh)
        fn = build_train_step(zoo, impl, microbatch=microbatch)
        return (fn, (params_abs, opt_abs, batch_abs),
                (params_shard, opt_shard, batch_shard),
                (params_shard, opt_shard, rep))
    if shape.kind == "prefill":
        batch_abs = _abstract_batch(zoo, shape)
        batch_shard = sh.batch_shardings(batch_abs, mesh)
        cache_abs = zoo.abstract_cache(shape.global_batch, shape.seq_len)
        cache_shard = sh.cache_shardings(cache_abs, mesh)
        fn = build_prefill_step(zoo, shape.seq_len, impl)
        return (fn, (params_abs, batch_abs), (params_shard, batch_shard),
                (rep, cache_shard, rep))
    # decode / long_decode: one new token against a seq_len KV cache
    if kv_int8:
        if cfg.family not in ("dense", "vlm"):
            raise ValueError(f"--kv-int8: dense-family only, not "
                             f"{cfg.family}")
        meta = torch.device("meta")
        b = shape.global_batch
        dec = {"token": torch.empty((b, 1), dtype=torch.int32, device=meta),
               "cache": _T.abstract_cache_q8(
                   cfg, b, shape.seq_len + (cfg.n_patches
                                            if cfg.family == "vlm" else 0)),
               "position": torch.empty((b,), dtype=torch.int32,
                                       device=meta)}

        def fn(p, t, c, pos):
            return _T.decode_step_q8(p, t, c, pos, cfg)
    else:
        dec = zoo.decode_input_specs(shape)
        fn = build_serve_step(zoo)
    cache_shard = sh.cache_shardings(dec["cache"], mesh)
    tok_shard = sh.batch_shardings({"token": dec["token"]}, mesh)["token"]
    pos_shard = sh.batch_shardings(
        {"position": dec["position"]}, mesh)["position"]
    return (fn, (params_abs, dec["token"], dec["cache"], dec["position"]),
            (params_shard, tok_shard, cache_shard, pos_shard),
            (rep, cache_shard, pos_shard))


def _pairs(tree, shardings) -> list:
    """(tensor, NamedSharding) for every leaf of ``tree``; ``shardings`` has
    its structure, or is one sharding for a whole subtree."""
    if isinstance(tree, (tuple, list)):
        return [x for t, s in zip(tree, shardings) for x in _pairs(t, s)]
    if isinstance(tree, dict):
        if isinstance(shardings, sh.NamedSharding):
            return [(t, shardings) for t in leaves(tree)]
        if set(tree) != set(shardings):
            raise ValueError(f"leaves {sorted(tree)} against shardings "
                             f"{sorted(shardings)}")
        return [x for k in tree for x in _pairs(tree[k], shardings[k])]
    return [(tree, shardings)]


class _Reach(TorchDispatchMode):
    """Follows which of ``sources`` (tensors) each tensor of a trace
    derives from: every op's outputs derive from the union of its tensor
    inputs' sources (an in-place op's output is one of its inputs).  A
    bitmask per tensor, keyed by id and checked by a weak reference, so a
    reused id never inherits a dead tensor's sources."""

    def __init__(self, sources):
        super().__init__()
        self.mask = {id(t): (weakref.ref(t), 1 << i)
                     for i, t in enumerate(sources)}

    def of(self, tensors) -> int:
        m = 0
        for a in tensors:
            if isinstance(a, torch.Tensor):
                e = self.mask.get(id(a))
                if e is not None and e[0]() is a:
                    m |= e[1]
        return m

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        m = self.of(tree_leaves_any((args, kwargs)))
        out = func(*args, **kwargs)
        for o in tree_leaves_any(out):
            if isinstance(o, torch.Tensor):
                if m:
                    self.mask[id(o)] = (weakref.ref(o), m)
                else:
                    self.mask.pop(id(o), None)
        return out


def sharded_bytes(tree, shardings, keep=None) -> int:
    """Bytes of one device's shards of every leaf (of leaf ``i`` only where
    bit ``i`` of ``keep`` is set, when given): each meta leaf laid out by
    its sharding (``NamedSharding.distribute``, a ``DTensor`` where the mesh
    has a ``DeviceMesh``), ``to_local()``'s size summed."""
    total = 0
    for i, (t, s) in enumerate(_pairs(tree, shardings)):
        if keep is not None and not keep >> i & 1:
            continue
        d = s.distribute(t)
        local = d.to_local() if hasattr(d, "to_local") else d
        if tuple(local.shape) != s.local_shape(t.shape):
            raise ValueError(f"{tuple(t.shape)} under {s.spec}: shard "
                             f"{tuple(local.shape)}, expected "
                             f"{s.local_shape(t.shape)}")
        total += local.numel() * local.element_size()
    return total


def trace_cell(arch: str, shape_name: str, mesh, impl: str = "chunked",
               microbatch: int = 1, act_hints: bool = True,
               kv_int8: bool = False) -> dict:
    """Lay one cell's arguments out on ``mesh`` and trace its step on meta
    at global shapes under ``set_act_mesh(mesh)`` (unless ``act_hints`` is
    off).  Returns the per-device argument and output bytes, the traced
    FLOPs and the seconds it took."""
    from torch.utils.flop_counter import FlopCounterMode
    fn, args, in_shard, out_shard = cell_program(
        arch, shape_name, mesh, impl, microbatch=microbatch, kv_int8=kv_int8)
    t0 = time.perf_counter()
    all_bytes = sharded_bytes(args, in_shard)
    sh.set_act_mesh(mesh if act_hints else None)
    try:
        counter = FlopCounterMode(display=False)
        reach = _Reach([t for t, _ in _pairs(args, in_shard)])
        with counter, reach, torch.no_grad():
            out = fn(*args)
    finally:
        sh.set_act_mesh(None)
    # jit drops the arguments no output depends on (``keep_unused=False``
    # after dead-code elimination), so XLA's argument bytes count only the
    # leaves the step's outputs derive from
    outs = _pairs(out, out_shard)
    arg_bytes = sharded_bytes(args, in_shard, reach.of(t for t, _ in outs))
    out_bytes = sharded_bytes(out, out_shard)
    return {"argument_size_in_bytes": arg_bytes,
            "unused_argument_bytes": all_bytes - arg_bytes,
            "output_size_in_bytes": out_bytes,
            "output_leaves": len(outs),
            "traced_flops": counter.get_total_flops(),
            "trace_s": time.perf_counter() - t0}


def analyze_cell(arch: str, shape_name: str, mesh_kind: str,
                 impl: str = "chunked", save: bool = True,
                 microbatch: int = 1, act_hints: bool = True,
                 kv_int8: bool = False, outdir: str | None = None,
                 mesh=None) -> dict:
    """One cell's record on the production mesh of ``mesh_kind`` (or on
    ``mesh``, e.g. a host mesh), saved as JSON unless ``save`` is off."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = math.prod(mesh.shape.values())
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    tr = trace_cell(arch, shape_name, mesh, impl, microbatch=microbatch,
                    act_hints=act_hints, kv_int8=kv_int8)

    # analytic terms
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6 * cfg.active_params() * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2 * cfg.active_params() * tokens
    else:
        tokens = shape.global_batch          # one token per sequence
        model_flops = 2 * cfg.active_params() * tokens

    flops = tr["traced_flops"]
    out = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": n_chips,
        "trace_s": tr["trace_s"],
        "memory_analysis": {
            "argument_size_in_bytes": tr["argument_size_in_bytes"],
            "output_size_in_bytes": tr["output_size_in_bytes"]},
        "unused_argument_bytes": tr["unused_argument_bytes"],
        "model_flops": model_flops,
        "tokens": tokens,
        "traced_flops": flops,
        "roofline": {"compute_s": flops / (n_chips * PEAK_FLOPS)},
        "departures": DEPARTURES,
    }
    if save:
        d = os.path.join(outdir or ARTIFACTS, mesh_kind)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{arch}__{shape_name}.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


def _table(records: list[dict]) -> str:
    """A markdown table of cell records, one row an (arch, shape), the
    meshes side by side ("single; multi"; one value where they agree)."""
    by_cell: dict = {}
    for r in records:
        by_cell.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def both(cell, get):
        vals = [str(get(cell[m])) if m in cell else "-"
                for m in ("single", "multi")]
        return vals[0] if vals[0] == vals[1] else "; ".join(vals)

    def arg(r):
        return r["memory_analysis"]["argument_size_in_bytes"]

    rows = ["| arch | shape | argument bytes / device | output bytes / "
            "device | traced_flops | model_flops | compute_s | arguments "
            "fit 80 GB | trace_s |", "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), cell in by_cell.items():
        rows.append(
            f"| {arch} | {shape} | {both(cell, arg)} | "
            f"{both(cell, lambda r: r['memory_analysis']['output_size_in_bytes'])}"
            f" | {both(cell, lambda r: r['traced_flops'])} | "
            f"{both(cell, lambda r: r['model_flops'])} | "
            f"{both(cell, lambda r: r['roofline']['compute_s'])} | "
            f"{both(cell, lambda r: 'yes' if arg(r) <= HBM_BYTES else 'no')}"
            f" | {both(cell, lambda r: r['trace_s'])} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--impl", default="chunked")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--no-act-hints", action="store_true")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in cells_for(get_config(a))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failures, records = [], []
    for mesh_kind in meshes:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=MESH_RANKS[mesh_kind])
        try:
            for arch, shape in cells:
                tag = f"{mesh_kind}/{arch}/{shape}"
                path = os.path.join(args.outdir or ARTIFACTS, mesh_kind,
                                    f"{arch}__{shape}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                try:
                    r = analyze_cell(arch, shape, mesh_kind, impl=args.impl,
                                     microbatch=args.microbatch,
                                     act_hints=not args.no_act_hints,
                                     kv_int8=args.kv_int8,
                                     outdir=args.outdir)
                    records.append(r)
                    print(f"[ok] {tag}: trace={r['trace_s']}s "
                          f"flops={r['traced_flops']:.3e} "
                          f"mem={r['memory_analysis']}", flush=True)
                except Exception as e:
                    failures.append((tag, str(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
        finally:
            dist.destroy_process_group()
    if records:
        print(_table(records))
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + ", ".join(t for t, _ in failures))
    print("dry-run complete: all cells traced")


if __name__ == "__main__":
    main()
