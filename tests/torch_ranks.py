"""Run checks of the port in a gloo process group of CPU ranks.

Not a test module: the ``tests/test_torch_*`` files that hold the port's
multi-device paths against the JAX package's meshes call :func:`run_ranks`
once per file. It spawns ``world`` processes, each of which joins the
group through the port's env contract (``PIO_TPU_COORDINATOR``,
``PIO_TPU_NUM_PROCESSES``, ``PIO_TPU_PROCESS_ID``) with ``ComputeContext.
create(device="cpu")``, runs every task in order and sends back its
results. The children import only ``torch`` and ``pio_tpu_torch``.
"""

from __future__ import annotations

import contextlib
import importlib
import multiprocessing as mp
import os
import socket
import traceback


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank: int, world: int, port: int, tasks, env, out,
           device: str = "cpu") -> None:
    try:
        for k, v in env.items():  # None unsets
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        os.environ["PIO_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        os.environ["PIO_TPU_NUM_PROCESSES"] = str(world)
        os.environ["PIO_TPU_PROCESS_ID"] = str(rank)
        import torch

        torch.set_num_threads(1)
        from pio_tpu_torch.parallel import distributed
        from pio_tpu_torch.parallel.context import ComputeContext

        ctx = ComputeContext.create(device=device)
        results = []
        for target, payload in tasks:
            module, name = target.rsplit(":", 1)
            fn = getattr(importlib.import_module(module), name)
            results.append(fn(ctx, payload))
        distributed.barrier()
        distributed.shutdown()
        out.put((rank, "ok", results))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _start(world: int, tasks, env, device: str):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, world, port, tasks, dict(env or {}), out,
                               device),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def _collect(world: int, procs, out, timeout: float) -> list:
    got = {}
    try:
        for _ in range(world):
            rank, status, value = out.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world)]


def run_ranks(world: int, tasks, env=None, timeout: float = 120.0,
              device: str = "cpu") -> list:
    """Run ``tasks`` — ``[("module:function", payload)]``, each called as
    ``function(ctx, payload)`` — on ``world`` ranks (gloo on the CPU, NCCL
    with ``device="cuda"``). Returns each rank's list of results, by rank;
    raises with a rank's traceback when one fails."""
    return _collect(world, *_start(world, tasks, env, device), timeout)


def run_groups(tasks_by_world: dict, env=None, timeout: float = 180.0) -> dict:
    """:func:`run_ranks` for several gloo groups at once, one a world size
    (``{world: tasks}``): every group's ranks start together. Returns
    ``{world: results by rank}``."""
    started = {w: _start(w, t, env, "cpu") for w, t in tasks_by_world.items()}
    return {w: _collect(w, *s, timeout) for w, s in started.items()}


# -- tasks: each runs in a rank as ``task(ctx, payload)`` ---------------------
def _numpy_tree(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def als_task(ctx, payload):
    """``train_als`` on the rank's group from the given initial factors,
    on the wire ``payload["wire"]``; returns (user, item) factors and the
    stats."""
    import numpy as np

    from pio_tpu_torch.models import als

    os.environ["PIO_TPU_ALS_MESH_WIRE"] = payload["wire"]
    if payload.get("init") is not None:
        init = iter(payload["init"])
        orig = als._init_factors
        als._init_factors = lambda n, rank, gen: __import__("torch") \
            .from_numpy(np.array(next(init), np.float32))
    try:
        stats = {}
        f = als.train_als(ctx, payload["u"], payload["i"], payload["r"],
                          payload["U"], payload["I"],
                          als.ALSConfig(**payload["cfg"]), stats=stats)
    finally:
        if payload.get("init") is not None:
            als._init_factors = orig
    return f.user_factors, f.item_factors, stats


def mlp_task(ctx, payload):
    """``train_mlp`` on the rank's group from the given initial params;
    returns the fitted params (host numpy)."""
    import torch

    from pio_tpu_torch.models import mlp

    p0 = {k: torch.from_numpy(v) for k, v in payload["init"].items()}
    orig = mlp.init_params
    mlp.init_params = lambda V, H, C, generator: {
        k: v.to(generator.device) for k, v in p0.items()}
    try:
        m = mlp.train_mlp(ctx, payload["ids"], payload["w"], payload["y"],
                          payload["V"], payload["C"],
                          mlp.MLPConfig(**payload["cfg"]))
    finally:
        mlp.init_params = orig
    return _numpy_tree({k: getattr(m, k)
                        for k in ("w_in", "b_in", "w_out", "b_out")})


def logreg_task(ctx, payload):
    """``train_logreg`` on the rank's group from the given initial
    params; returns (weights, bias)."""
    import torch

    from pio_tpu_torch.models import logreg

    p0 = {k: torch.from_numpy(v) for k, v in payload["init"].items()}
    orig = logreg.init_params
    logreg.init_params = lambda d, c, seed: dict(p0)
    try:
        m = logreg.train_logreg(ctx, payload["X"], payload["y"],
                                payload["C"],
                                logreg.LogRegConfig(**payload["cfg"]))
    finally:
        logreg.init_params = orig
    return m.weights, m.bias


def group_task(ctx, payload):
    """The group's facts and one run of each collective and placement."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pio_tpu_torch.parallel import distributed, partition
    from pio_tpu_torch.parallel.mesh import mesh_axis_size

    r = ctx.rank
    x = torch.full((3, 4), float(r + 1))
    total = distributed.all_reduce_sum(x.sum().reshape(1), ctx.group)
    full = torch.arange(8, dtype=torch.float32).reshape(4, 2) + r
    u16 = np.array([[r, 65535 - r]], np.uint16)
    gathered = distributed.all_gather_rows(torch.from_numpy(u16), ctx.group)
    n_rows = 3 if r == 0 else 5
    xs = np.full((n_rows, 2), float(r))
    ys = np.arange(n_rows) + 100 * r
    batch = ctx.shard_batch({"ids": np.arange(5)}, pad_value=-1)
    table = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    placed, specs = ctx.shard_params(
        {"user_factors": table, "bias": np.ones(3, np.float32)},
        template="als")
    return {
        "rank": r, "world": ctx.world_size, "num_devices": ctx.num_devices,
        "coordinator": ctx.is_coordinator, "backend": dist.get_backend(),
        "device": str(ctx.device), "mesh_shape": list(ctx.mesh.shape),
        "data_axis": mesh_axis_size(ctx.mesh, "data"),
        "model_axis": mesh_axis_size(ctx.mesh, "model"),
        "all_reduce": float(total),
        "reduce_scatter": distributed.reduce_scatter_rows(
            full, ctx.group).numpy(),
        "all_gather": gathered.numpy(),
        "global": distributed.host_local_to_global(ctx, [xs, ys]),
        "shard_batch": (batch["ids"].numpy(), batch["mask"].numpy()),
        "shard_params": (placed["user_factors"].numpy(),
                         tuple(specs["user_factors"]),
                         placed["bias"].numpy()),
    }


def run_train_task(ctx, payload):
    """``run_train`` of a variant on the rank's group (SQLite storage
    under the shared home); returns the instance id."""
    from pio_tpu_torch.workflow.core_workflow import run_train
    from pio_tpu_torch.workflow.engine_json import (
        build_engine,
        variant_from_dict,
    )

    variant = variant_from_dict(payload)
    engine, ep = build_engine(variant)
    return run_train(engine, ep, variant, ctx=ctx)


# -- the neural templates over a mesh ------------------------------------------
def _tensor_tree(tree):
    """A nested dict of numpy arrays as CPU tensors."""
    import numpy as np
    import torch

    return {k: _tensor_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


def _flat_numpy(tree, pre=""):
    """A nested dict of tensors as ``{"a/b": numpy}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_numpy(v, pre + k + "/"))
        else:
            out[pre + k] = v.detach().cpu().numpy()
    return out


def _mesh(ctx, spec):
    from pio_tpu_torch.parallel.mesh import MeshSpec

    return ctx.mesh_for(MeshSpec(**spec))


def _task_env(payload) -> None:
    """Set the payload's ``env`` knobs in this rank (they stay for the
    rank's later tasks only where a task sets them again)."""
    for k, v in (payload.get("env") or {}).items():
        os.environ[k] = v


def twotower_task(ctx, payload):
    """``train_two_tower`` over the mesh ``payload["spec"]`` of the rank's
    group, from the given initial towers (the port's own without
    ``init``), snapshotting every ``every`` steps under ``checkpoint``
    when it names a directory, under the payload's ``env`` knobs; returns
    the (user, item) vector tables, and the run's stats where ``stats``
    is set."""
    from pio_tpu_torch.models import two_tower as T

    _task_env(payload)
    mesh = _mesh(ctx, payload["spec"])
    orig = T.init_params
    if payload.get("init") is not None:
        T.init_params = lambda vu, vi, cfg, generator: _tensor_tree(
            payload["init"])
    kw = {}
    if payload.get("checkpoint"):
        from pio_tpu_torch.workflow.checkpoint import CheckpointManager

        kw = dict(checkpoint=CheckpointManager(payload["checkpoint"]),
                  checkpoint_every=payload["every"])
    stats = {} if payload.get("stats") else None
    try:
        m = T.train_two_tower(mesh, payload["u"], payload["i"], payload["U"],
                              payload["I"], T.TwoTowerConfig(**payload["cfg"]),
                              device=ctx.device, stats=stats, **kw)
    finally:
        T.init_params = orig
    out = m.user_vectors.cpu().numpy(), m.item_vectors.cpu().numpy()
    return out if stats is None else (*out, stats)


def seqrec_task(ctx, payload):
    """``train_seqrec`` over the mesh ``payload["spec"]``, from the given
    initial parameters (the port's own without ``init``), under the
    payload's ``env`` knobs; returns the parameters, flat
    (``blocks/wq``...), and the run's stats where ``stats`` is set."""
    from pio_tpu_torch.models import seqrec as S

    _task_env(payload)
    mesh = _mesh(ctx, payload["spec"])
    orig = S.init_params
    if payload.get("init") is not None:
        S.init_params = lambda vocab, cfg, generator: _tensor_tree(
            payload["init"])
    stats = {} if payload.get("stats") else None
    try:
        m = S.train_seqrec(mesh, payload["seqs"], payload["n_items"],
                           S.SeqRecConfig(**payload["cfg"]), device=ctx.device,
                           stats=stats)
    finally:
        S.init_params = orig
    return _flat_numpy(m.params) if stats is None else (
        _flat_numpy(m.params), stats)


def seqrec_grad_task(ctx, payload):
    """One step's loss and gradients of ``train_seqrec``'s loss over the
    mesh ``payload["spec"]`` at the given parameters and full batch
    (its whole padded rows and positions), each gradient gathered whole;
    flat."""
    import numpy as np
    import torch

    from pio_tpu_torch.models import seqrec as S
    from pio_tpu_torch.models.adam import leaves, rebuild
    from pio_tpu_torch.parallel import collectives as C
    from pio_tpu_torch.parallel.partition import gather_shards, local_shards

    mesh = _mesh(ctx, payload["spec"])
    axes = S.MeshAxes.of(mesh)
    cfg = S.SeqRecConfig(**payload["cfg"])
    init = _tensor_tree(payload["init"])
    specs = S.param_specs(init)
    local = local_shards(mesh, init, specs)
    p = [t.requires_grad_(True) for t in leaves(local)]
    seqs, targets, mask = (np.asarray(payload[k]) for k in
                           ("seqs", "targets", "mask"))
    b_loc = seqs.shape[0] // C.axis_size(axes.data)
    t_loc = seqs.shape[1] // C.axis_size(axes.seq)
    r0 = C.axis_index(axes.data) * b_loc
    c0 = C.axis_index(axes.seq) * t_loc
    batch = [torch.from_numpy(np.ascontiguousarray(
        a[r0:r0 + b_loc, c0:c0 + t_loc])) for a in (seqs, targets, mask)]
    loss = S._loss(rebuild(local, p), *batch, cfg, axes)
    grads = C.all_reduce_flat(torch.autograd.grad(loss, p),
                              [axes.data, axes.seq])
    whole = gather_shards(mesh, rebuild(local, grads), specs,
                          rebuild(init, [t.shape for t in leaves(init)]))
    return float(loss), _flat_numpy(whole)


def pieces_task(ctx, payload):
    """The parallel pieces over one axis of the rank's group (the mesh
    ``payload["spec"]``, the axis ``payload["axis"]``): each piece's local
    output and the gradients of ``Σ <output, cotangent>`` with respect to
    its local inputs. The inputs and cotangents are the whole arrays;
    each rank takes its slices here."""
    import numpy as np
    import torch

    from pio_tpu_torch.parallel import collectives as C
    from pio_tpu_torch.parallel.mesh import mesh_axis_group
    from pio_tpu_torch.parallel.pipeline import pipeline_apply
    from pio_tpu_torch.parallel.ring import ring_attention
    from pio_tpu_torch.parallel.ulysses import ulysses_attention
    from pio_tpu_torch.parallel.vocab import (
        vocab_parallel_lookup,
        vocab_parallel_target_gather,
    )

    axis = mesh_axis_group(_mesh(ctx, payload["spec"]), payload["axis"])
    n, r = C.axis_size(axis), C.axis_index(axis)

    def piece(a, dim):
        a = torch.from_numpy(np.array(a, np.float32))
        return a.chunk(n, dim)[r].contiguous().requires_grad_(True)

    def whole(a):
        return torch.from_numpy(np.array(a, np.float32)).requires_grad_(True)

    def run(fn, inputs, cot):
        out = fn(*inputs)
        grads = torch.autograd.grad((out * cot).sum(), inputs)
        return out.detach().numpy(), [g.numpy() for g in grads]

    got = {}
    for name, case in payload["cases"].items():
        if name == "lookup":
            ids = torch.from_numpy(case["ids"])
            got[name] = run(lambda t: vocab_parallel_lookup(t, ids, axis),
                            [piece(case["table"], 0)],
                            torch.from_numpy(case["cot"]))
        elif name == "target":
            tg = torch.from_numpy(case["targets"])
            got[name] = run(
                lambda lg: vocab_parallel_target_gather(lg, tg, axis),
                [piece(case["logits"], -1)], torch.from_numpy(case["cot"]))
        elif name in ("ring", "ulysses"):
            fn = ring_attention if name == "ring" else ulysses_attention
            got[name] = run(
                lambda q, k, v: fn(q, k, v, axis=axis,
                                   causal=case["causal"]),
                [piece(case[k], 1) for k in "qkv"],
                torch.from_numpy(case["cot"]).chunk(n, 1)[r])
        elif name == "pipeline":
            def stage(p, x):
                for layer in range(p["w"].shape[0]):
                    x = torch.tanh(x @ p["w"][layer] + p["b"][layer])
                return x

            got[name] = run(
                lambda w, b, x: pipeline_apply({"w": w, "b": b}, x, stage,
                                               axis=axis),
                [piece(case["w"], 0), piece(case["b"], 0), whole(case["x"])],
                torch.from_numpy(case["cot"]))
    return got


@contextlib.contextmanager
def group_of_one():
    """An in-process gloo group of one rank (a ``HashStore``, no socket)
    and its context, for the world-size-1 checks that need no spawn; the
    group is destroyed on exit."""
    import torch.distributed as dist

    from pio_tpu_torch.parallel.context import ComputeContext
    from pio_tpu_torch.parallel.mesh import build_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = build_mesh("cpu")
        yield ComputeContext(device=__import__("torch").device("cpu"),
                             mesh=mesh, group=mesh.get_group("data"))
    finally:
        dist.destroy_process_group()


def template_task(ctx, payload):
    """``run_train`` of the variant ``payload`` on the rank's group
    twice, persisted whole and then with ``PIO_TPU_SHARDED_PERSIST=1``;
    returns both instance ids and the warnings the runs logged."""
    import logging

    said = []

    class Said(logging.Handler):
        def emit(self, record):
            said.append(record.getMessage())

    handler = Said(level=logging.WARNING)
    logger = logging.getLogger("pio_tpu_torch")
    logger.addHandler(handler)
    iids = []
    try:
        for sharded in ("0", "1"):
            os.environ["PIO_TPU_SHARDED_PERSIST"] = sharded
            iids.append(run_train_task(ctx, payload))
    finally:
        logger.removeHandler(handler)
        os.environ.pop("PIO_TPU_SHARDED_PERSIST", None)
    return {"iids": iids, "warnings": said}
