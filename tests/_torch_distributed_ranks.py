"""Rank processes for `tests/test_torch_distributed.py` and
`tests/test_torch_distributed_cuda.py` (no JAX here).

    python tests/_torch_distributed_ranks.py KIND IN OUT

spawns the ranks of one group, runs every case of that group in it, and
writes what rank 0 (or every rank, where a result is per rank) got into
the directory OUT as torch files. KIND is one of
- `train`: 4 gloo ranks on the host;
- `train_cuda`: 2 gloo ranks sharing cuda:0;
- `train_nccl`: 2 NCCL ranks, one card each;
- `collectives`: 16 gloo ranks on the host.
IN is a torch file of inputs made by the test (the initial parameters,
fp32, in the port's tree). A rank that fails makes
`torch.multiprocessing.spawn` stop the others and exit non-zero; a
collective that waits longer than the group's timeout fails.
"""
import datetime
import socket
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = Path(__file__).resolve().parents[1] / "src"
DTYPES = ("float32", "bfloat16")
STEPS = 3
SHAPE = dict(seq_len=32, global_batch=8)


def _start(rank, world, port, backend="gloo", device="cpu"):
    """Join the group; returns this rank's device (its own card under NCCL)."""
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    from repro_torch.launch.mesh import rank_device
    return rank_device(device, backend)


def meshes(world: int) -> tuple:
    """(data, model) shapes over `world` ranks: all data, square, all model."""
    out = [(world, 1), (world // 2, 2), (1, world)]
    return tuple(m for i, m in enumerate(out) if m[0] >= 1 and m not in out[:i])


def _steps(step, state, pipe, steps, start=0):
    hist = []
    for s in range(start, start + steps):
        state, m = step(state, pipe.batch_at(s))
        hist.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
    return state, hist


def _cpu(tree):
    from repro_torch.tree import state_leaves, state_unflatten
    return state_unflatten(tree, [x.detach().cpu().clone() for x in state_leaves(tree)])


def train_cases(rank, world, port, inp, out, backend="gloo", device="cpu"):
    dev = _start(rank, world, port, backend, device)
    from repro_torch.configs.base import DEFAULT_RUN, ShapeConfig, get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import TrainState, init_train_state, make_train_step
    from repro_torch.launch.train import GatheredCheckpoint, build_trainer, train
    from repro_torch.checkpoint import CheckpointManager, restore_tree
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import OptState, init_opt_state
    from repro_torch.parallel import ProcessMesh, gather_tree, shard_tree
    from repro_torch.parallel.pipeline import pipeline_apply, split_stages
    from repro_torch.parallel.collectives import (
        _all_gather_by_all_reduce,
        _reduce_scatter_by_all_reduce,
        all_gather,
        reduce_scatter,
    )
    from repro_torch.runtime import rebalance_grad_accum, reshard_state, shrink_mesh
    from repro_torch.tree import state_leaves, tree_map

    res = {}
    cfg = get_config("qwen3-0.6b", reduced=True)
    shape = ShapeConfig("t", SHAPE["seq_len"], SHAPE["global_batch"], "train")
    pipe = make_pipeline(cfg, shape.seq_len, shape.global_batch, seed=0)
    init32 = tree_map(lambda p: p.to(dev), torch.load(inp, weights_only=False)["params"])
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def start_state(step, dtype):
        params = shard_tree(tree_map(lambda p: p.to(dts[dtype]).clone(), init32),
                            step.specs.params, step.mesh)
        return TrainState(params=params, opt=init_opt_state(params, torch.float32))

    # the sharded trainer on each mesh, dtype and grad_accum; the unsharded one
    for dtype in DTYPES:
        for ga in (1, 2):
            run = DEFAULT_RUN.replace(param_dtype=dtype, remat="none", grad_accum=ga,
                                      warmup_steps=0)
            if rank == 0:
                st = TrainState(params=tree_map(lambda p: p.to(dts[dtype]).clone(), init32),
                                opt=None)
                st = st._replace(opt=init_opt_state(st.params, torch.float32))
                st, hist = _steps(make_train_step(cfg, run, 10, device=dev), st, pipe, STEPS)
                res[("unsharded", dtype, ga)] = {"hist": hist, "params": _cpu(st.params)}
            for shp in meshes(world):
                mesh = ProcessMesh(shp, ("data", "model"), device=dev)
                step, _ = build_trainer(cfg, run, shape, mesh, 10, seed=0)
                state, hist = _steps(step, start_state(step, dtype), pipe, STEPS)
                whole = gather_tree(state, step.specs, mesh)
                if rank == 0:
                    res[(shp, dtype, ga)] = {"hist": hist, "params": _cpu(whole.params),
                                             "specs": step.specs.params,
                                             "local": {k: tuple(v.shape) for k, v in
                                                       state.params.items() if k == "embed"}}

    # the trainer's own draw: build_trainer against init_train_state, seed 0
    run = DEFAULT_RUN.replace(param_dtype="float32", remat="none")
    mesh = ProcessMesh((2, world // 2), ("data", "model"), device=dev)
    step, state = build_trainer(cfg, run, shape, mesh, 10, seed=0)
    whole = gather_tree(state, step.specs, mesh)
    if rank == 0:
        ref = init_train_state(cfg, run, torch.Generator().manual_seed(0), device=dev)
        res["draw"] = {"sharded": _cpu(whole.params), "unsharded": _cpu(ref.params)}

    # MoE: routing is a whole-batch statistic. Two steps at the default
    # warm-up, and one at the peak rate (its change to each leaf): past a
    # moving step, a 1e-7 change of the weights flips routes and moves the
    # next grad norm by ~1e-4, so a moving state is compared after one step
    moe = get_config("arctic-480b", reduced=True)
    mpipe = make_pipeline(moe, 16, 4, seed=0)
    mshape = ShapeConfig("t", 16, 4, "train")
    run = DEFAULT_RUN.replace(param_dtype="float32", remat="none")
    try:
        build_trainer(moe, run, mshape, ProcessMesh((2, world // 2), ("data", "model"),
                                                    device=dev), 10)
        res["moe_error"] = None
    except ValueError as e:
        res["moe_error"] = str(e)
    mesh = ProcessMesh((1, world), ("data", "model"), device=dev)
    for tag, mrun, n in (("moe", run, 2), ("moe_peak", run.replace(warmup_steps=0), 1)):
        step, state = build_trainer(moe, mrun, mshape, mesh, 10, seed=0)
        state, hist = _steps(step, state, mpipe, n)
        whole = gather_tree(state, step.specs, mesh)
        if rank == 0:
            ref = init_train_state(moe, mrun, torch.Generator().manual_seed(0), device=dev)
            init = _cpu(ref.params)
            ref, rhist = _steps(make_train_step(moe, mrun, 10, device=dev), ref, mpipe, n)
            res[tag] = {"hist": hist, "params": _cpu(whole.params), "ref_hist": rhist,
                        "ref_params": _cpu(ref.params), "init": init}

    # elastic: (2, world / 2) -> one step -> shrink to (1, world / 2) -> reshard -> a step
    run = DEFAULT_RUN.replace(param_dtype="float32", remat="none", warmup_steps=0)
    mesh = ProcessMesh((2, world // 2), ("data", "model"), device=dev)
    step, _ = build_trainer(cfg, run, shape, mesh, 10)
    state, hist0 = _steps(step, start_state(step, "float32"), pipe, 1)
    whole = gather_tree(state, step.specs, mesh)
    ckdir = Path(out) / "elastic_ckpt"
    ck = GatheredCheckpoint(CheckpointManager(ckdir), step.specs, mesh)
    ck.save(1, state, extra={"step": 1}, block=True)
    ck.close()
    new = shrink_mesh(mesh, lost_data_slices=1)
    run2 = rebalance_grad_accum(run, mesh, new)
    el = {"member": new.member, "grad_accum": run2.grad_accum, "hist0": hist0}
    if new.member:
        paxes = M.param_axes(cfg)
        axes = TrainState(params=paxes, opt=OptState(step=(), m=paxes, v=paxes))
        from_gather = reshard_state(whole, axes, new)
        restored = restore_tree(whole, ckdir / "step_00000001")
        from_ckpt = reshard_state(restored, axes, new)
        step2, _ = build_trainer(cfg, run2, shape, new, 10)
        same = all(torch.equal(a, b) for a, b in zip(state_leaves(from_gather),
                                                     state_leaves(from_ckpt)))
        s2, hist1 = _steps(step2, from_ckpt, pipe, 1, start=1)
        el.update(same=same, hist1=hist1, params=_cpu(gather_tree(s2, step2.specs, new).params),
                  params1=_cpu(whole.params), new_shape=new.shape)
    if rank == 0:
        st = TrainState(params=tree_map(lambda p: p.clone(), init32), opt=None)
        st = st._replace(opt=init_opt_state(st.params, torch.float32))
        st, r0 = _steps(make_train_step(cfg, run, 10, device=dev), st, pipe, 1)
        p1 = _cpu(st.params)
        st, r1 = _steps(make_train_step(cfg, run2, 10, device=dev), st, pipe, 1, start=1)
        el["ref"] = {"hist0": r0, "hist1": r1, "params": _cpu(st.params), "params1": p1}
    torch.save(el, Path(out) / f"elastic_{rank}.pt")

    # train(model_axis=2) over the ranks, with its whole-array checkpoints
    ckpt = Path(out) / "train_ckpt"
    _, hist = train("qwen3-0.6b", steps=2, global_batch=4, seq_len=16, device=dev,
                    model_axis=2, ckpt_dir=str(ckpt), checkpoint_every=1, resume=False)
    if rank == 0:
        res["train"] = {"hist": [(h["loss"], h["grad_norm"]) for h in hist],
                        "ckpt": str(ckpt)}

    # GPipe over a ("pod",) mesh of the ranks: the reference test's case
    # (L 8, D 16, M 6, mb 4), and on a card D 1024 (weights scaled by
    # 0.3 * 4 / sqrt(D), the case's 0.3 at D 16)
    mesh = ProcessMesh((world,), ("pod",), device=dev)
    pipes = {}
    for d in (16, 1024) if dev.type == "cuda" else (16,):
        rng = np.random.default_rng(0)
        ws = torch.from_numpy((rng.standard_normal((8, d, d)) * 1.2 / np.sqrt(d))
                              .astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((6, 4, d)).astype(np.float32)).to(dev)

        def stage_fn(sp, h):
            for i in range(sp.shape[0]):
                h = torch.tanh(h @ sp[i])
            return h

        stages = split_stages(ws, world).requires_grad_(True)
        y = pipeline_apply(stage_fn, stages, x, mesh=mesh, axis="pod")
        (y ** 2).sum().backward()
        pipes[d] = {"y": y.detach().cpu(), "grad": stages.grad.cpu(),
                    "stage": mesh.coords["pod"], "ws": ws.cpu(), "x": x.cpu()}
    torch.save(pipes, Path(out) / f"pipeline_{rank}.pt")

    # the gather gloo's CUDA tensors take (all_reduce of a zero buffer)
    mesh = ProcessMesh((2, world // 2), ("data", "model"), device=dev)
    v = (torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) + 10 * rank).to(dev)
    g = mesh.group("data")
    by_reduce = _all_gather_by_all_reduce(v, g[0], 2, mesh.index("data"))
    native = all_gather(v, mesh, "data")
    if rank == 0:
        res["gather"] = torch.equal(by_reduce.reshape(native.shape).cpu(), native.cpu())
    # and the reduce-scatter they take (all_reduce and a slice), along dims 0 and 1
    w = (torch.arange(24, dtype=torch.float32).reshape(4, 6) * (rank + 1)).to(dev)
    same = []
    for dim in (0, 1):
        native = reduce_scatter(w.clone(), mesh, "data", dim=dim)
        by_reduce = _reduce_scatter_by_all_reduce(w.clone(), g[0], 2, mesh.index("data"), dim)
        same.append(torch.equal(native.cpu(), by_reduce.cpu()))
    if rank == 0:
        res["reduce_scatter"] = same
    if rank == 0:
        torch.save(res, Path(out) / "train.pt")
    dist.barrier()
    dist.destroy_process_group()


def collective_cases(rank, world, port, inp, out):
    _start(rank, world, port)
    from repro_torch.parallel import ProcessMesh, bucketed_psum, compressed_psum

    x = torch.load(inp, weights_only=False)["x"]  # (16, 64), row r on rank r
    mesh = ProcessMesh((4, 4), ("pod", "data"), device="cpu")
    mine = x[rank].clone()
    res = {"n4": compressed_psum(mine, mesh, "data"),
           "n16": compressed_psum(mine, mesh, ("pod", "data")),
           "n4_sr": compressed_psum(mine, mesh, "data",
                                    generator=torch.Generator().manual_seed(rank)),
           "n16_group": compressed_psum(mine, dist.group.WORLD),
           "bucket": bucketed_psum({"a": mine, "b": mine[:16] * 2}, mesh, ("pod", "data"))}
    torch.save(res, Path(out) / f"collectives_{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    kind, inp, out = sys.argv[1:4]
    fn, n, extra = {"train": (train_cases, 4, ()),
                    "train_cuda": (train_cases, 2, ("gloo", "cuda:0")),
                    "train_nccl": (train_cases, 2, ("nccl", "cuda")),
                    "collectives": (collective_cases, 16, ())}[kind]
    mp.spawn(fn, args=(n, free_port(), inp, out, *extra), nprocs=n)
