"""Entry points: a one-card forward step and the multi-rank dry runs.

    python -m ct_diffusionmodelbench_tpu_torch.entry [--device cpu]

Counterpart of the root ``__graft_entry__.py``.  ``__main__`` runs
:func:`dryrun_multichip` (``CTDB_DRYRUN_DEVICES`` ranks, default 8), then
the :func:`entry` forward, and prints ``entry forward: <shape> <dtype>``.

- :func:`entry` returns ``(forward_step, (params, example_ids))``: the
  forward of the largest dense preset one card holds whole, ``llada-8b``
  in bf16 (about 16.3 GB of the H100's 80), or ``llada-tiny`` with
  ``device="cpu"``; the ids are ones at (1, 320).
- :func:`dryrun_multichip` spawns ``n_devices`` ranks and runs one training
  step over a dp × tp mesh (``llada-moe-tiny``: batch over ``data``; heads,
  FFN columns, experts and vocabulary over ``model``); at eight ranks or
  more also a dp 2 × sp 2 × tp step (ring attention over ``seq``), and a
  dp 2 × 4-stage GPipe forward and a dp 2 × pp 2 × tp 2 forward, each
  against the one-rank forward.  Ranks take a card each over nccl where the
  machine has ``n_devices`` cards, else all share ``cuda:0`` over gloo
  (``parallel/mesh.py::init_distributed``'s shared-card mode), or run on
  the CPU over gloo with ``device="cpu"``.  On the card the presets run in
  bf16 (the flash and grouped kernels take bf16 only) and the pipelined
  logits are held within 2^-5 of the largest |logit| (``chip_smoke.py``
  phase 25 (b)'s bound); on the CPU in f32 within 1e-4, the reference's
  bound.  Rank 0's lines are printed as they come; a rank that fails, or
  that has not finished within ``CTDB_DRYRUN_DEADLINE_S`` (540 s), stops
  every rank and the dry run raises.

Left out of the reference's, as shared-TPU-pool mechanics: ``probe_backend``
(the backend probe in a subprocess) and ``_reexec_dryrun_on_cpu`` (the
re-exec onto a virtual CPU mesh).  The pipeline check's parameters come
from the port's seeded init on the host (seed 3) and its ids from numpy
(``default_rng(4)``), where the reference draws both from JAX keys.
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device

ENTRY_SEQ = 320
DEADLINE_S = 540.0
LOGITS_RTOL_OF_MAX = 2 ** -5   # bf16 logits on the card
LOGITS_ATOL_F32 = 1e-4         # f32 on the CPU, as the reference


def entry(device: DeviceLike = None):
    """(forward_step, (params, example_ids)): ``forward_step(params,
    input_ids)`` returns the logits, under ``torch.inference_mode``."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn

    dev = resolve_device(device)
    cfg = get_config("llada-8b" if dev.type == "cuda" else "llada-tiny")
    params = init_params(cfg, seed=0, device=dev)
    fwd = make_forward_fn(cfg, dev)

    @torch.inference_mode()
    def forward_step(params, input_ids):
        logits, _ = fwd(params, input_ids)
        return logits

    example_ids = torch.ones((1, ENTRY_SEQ), dtype=torch.long, device=dev)
    return forward_step, (params, example_ids)


# ---------------------------------------------------------------------------
# multi-rank dry run
# ---------------------------------------------------------------------------

def _layout(n: int, device: DeviceLike):
    """(backend, device of every rank or None for a card each)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", "cpu"
    resolve_device(device)   # raises without a card
    if torch.cuda.device_count() >= n:
        return "nccl", None
    return "gloo", "cuda:0"


def _dtype(dev: torch.device) -> str:
    return "bfloat16" if dev.type == "cuda" else "float32"


def _dp_tp_step(n, dev, say, params=None, noise=None) -> dict:
    """One training step of ``llada-moe-tiny`` over a dp × tp mesh."""
    from ct_diffusionmodelbench_tpu_torch.io.bridge import shard_from_numpy
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.parallel import make_mesh
    from ct_diffusionmodelbench_tpu_torch.parallel.sharding import init_sharded_params
    from ct_diffusionmodelbench_tpu_torch.train.trainer import (
        TrainConfig, make_optimizer, make_train_step)

    dp = 2 if n % 2 == 0 and n > 1 else 1
    tp = n // dp
    mesh = make_mesh(data=dp, model=tp, device=dev)
    cfg = get_config("llada-moe-tiny", dtype=_dtype(dev)).replace(pad_token_id=0)
    shard = (init_sharded_params(cfg, 0, mesh) if params is None
             else shard_from_numpy(cfg, params, mesh))
    tc = TrainConfig(batch_size=dp * 2, grad_accum=2, max_length=32, learning_rate=1e-4,
                     warmup_steps=1, remat=True, dp=dp, tp=tp)
    optimizer, _ = make_optimizer(tc, total_steps=10)
    opt_state = optimizer.init(shard)
    step, _ = make_train_step(cfg, tc, optimizer, dev, mesh)
    a, b, l = tc.grad_accum, tc.batch_size, 16
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size - 2, size=(a, b, l))).long()
    plens = torch.full((a, b), 4)
    if noise is None:
        noise = torch.Generator(device=dev).manual_seed(1)
    else:
        noise = tuple(torch.as_tensor(x) for x in noise)
    _, _, metrics = step(shard, opt_state, ids, plens, noise)
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    say(f"dryrun_multichip ok: mesh=({dp}x{tp}), loss={loss:.4f}, "
        f"grad_norm={grad_norm:.4f}")
    return dict(loss=loss, grad_norm=grad_norm, mesh=(dp, tp))


def _sp_step(n, dev, say) -> dict:
    """One dp 2 × sp 2 × tp training step of ``llada-tiny`` (ring
    attention over ``seq``)."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.parallel import make_mesh
    from ct_diffusionmodelbench_tpu_torch.parallel.sharding import init_sharded_params
    from ct_diffusionmodelbench_tpu_torch.train.trainer import (
        TrainConfig, make_optimizer, make_train_step)

    tp = n // 4
    mesh = make_mesh(data=2, seq=2, model=tp, device=dev)
    cfg = get_config("llada-tiny", dtype=_dtype(dev)).replace(pad_token_id=0)
    shard = init_sharded_params(cfg, 0, mesh)
    tc = TrainConfig(batch_size=2, grad_accum=2, max_length=32, learning_rate=1e-4,
                     warmup_steps=1, dp=2, sp=2, tp=tp)
    optimizer, _ = make_optimizer(tc, total_steps=10)
    step, _ = make_train_step(cfg, tc, optimizer, dev, mesh)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size - 2, size=(2, 2, 32))).long()
    plens = torch.full((2, 2), 4)
    _, _, metrics = step(shard, optimizer.init(shard), ids, plens,
                         torch.Generator(device=dev).manual_seed(2))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite SP loss {loss}")
    say(f"dryrun sp ok: mesh=(2x2x{tp}), loss={loss:.4f}")
    return dict(sp_loss=loss)


def _pp_forwards(dev, say) -> dict:
    """A dp 2 × 4-stage and a dp 2 × pp 2 × tp 2 GPipe forward of a
    4-layer ``llada-tiny`` against the one-rank forward."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.ops.quant import place_params
    from ct_diffusionmodelbench_tpu_torch.parallel.pipeline import (
        make_pp_forward, make_pp_mesh, shard_params_pp)

    cfg4 = get_config("llada-tiny", dtype=_dtype(dev)).replace(num_layers=4)
    host = init_params(cfg4, seed=3, device="cpu")
    p4 = place_params(host, dev)
    ids4 = torch.from_numpy(
        np.random.default_rng(4).integers(3, cfg4.vocab_size - 2, size=(4, 32))).long().to(dev)
    out = {}
    with torch.inference_mode():
        want, _ = make_forward_fn(cfg4, dev)(p4, ids4)
        for key, line, mesh_kw in (
                ("pp_err", "pp ok: mesh=(2x4 stages)", dict(stages=4, data=2)),
                ("pptp_err", "pp-tp ok: mesh=(dp2 x pp2 x tp2)",
                 dict(stages=2, data=2, model=2))):
            mesh = make_pp_mesh(device=dev, **mesh_kw)
            got, _ = make_pp_forward(cfg4, mesh, num_microbatches=2)(
                shard_params_pp(cfg4, host, mesh), ids4)
            err = float((got.float() - want.float()).abs().max())
            if dev.type == "cuda":
                bound = LOGITS_RTOL_OF_MAX * float(want.float().abs().max())
            else:
                bound = LOGITS_ATOL_F32
            if not err < bound:
                raise AssertionError(f"{line.split(':')[0]} against the one-rank forward: "
                                     f"max abs err {err} (bound {bound})")
            say(f"dryrun {line}, max_abs_err={err:.2e}")
            out[key] = err
    return out


def _rank_main(rank, n, port, backend, device, params, noise, events):
    """A spawned rank: join the group, run the dry run's steps, report
    rank 0's lines as they come and every rank's end."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    torch.set_num_threads(1)

    def say(line):
        if rank == 0:
            events.put(("line", rank, line))

    try:
        from ct_diffusionmodelbench_tpu_torch.parallel import init_distributed

        dev = init_distributed(f"localhost:{port}", n, rank, backend=backend, device=device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        out = _dp_tp_step(n, dev, say, params, noise)
        if n >= 8:
            out.update(_sp_step(n, dev, say))
            out.update(_pp_forwards(dev, say))
        events.put(("done", rank, out))
    except BaseException:  # reported to the parent, which stops every rank
        events.put(("error", rank, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: DeviceLike = None, *, params=None,
                     noise=None) -> dict:
    """Run the dry run on ``n_devices`` spawned ranks; returns rank 0's
    numbers (loss and gradient norm of the dp × tp step; at eight ranks or
    more the sp loss and the pipelines' errors).

    ``params`` (a numpy tree of the whole ``llada-moe-tiny``) and ``noise``
    (``(t [A, B], u [A, B, L])``) replace the dp × tp step's seeded init
    and noise: the tests hand it the JAX init and the JAX noise."""
    import torch.multiprocessing as mp

    backend, rank_device = _layout(n_devices, device)
    deadline_s = float(os.environ.get("CTDB_DRYRUN_DEADLINE_S", DEADLINE_S))
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    events = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_devices, port, backend, rank_device, params, noise,
                               events))
             for r in range(n_devices)]
    results = [None] * n_devices
    deadline = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        while any(r is None for r in results):
            try:
                kind, rank, value = events.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise RuntimeError(
                    f"dryrun_multichip: ranks {[r for r, v in enumerate(results) if v is None]} "
                    f"did not finish within the deadline ({deadline_s:.0f} s)") from None
            if kind == "line":
                print(value, flush=True)
            elif kind == "error":
                raise RuntimeError(f"dryrun_multichip: rank {rank} failed:\n{value}")
            else:
                results[rank] = value
    finally:
        done = all(r is not None for r in results)
        for p in procs:
            p.join(timeout=30 if done else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return results[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' for CPU ranks and the tiny "
                                                   "forward; default: the card")
    args = ap.parse_args(argv)
    dryrun_multichip(int(os.environ.get("CTDB_DRYRUN_DEVICES", "8")), args.device)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry forward:", tuple(out.shape), out.dtype, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
