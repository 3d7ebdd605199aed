"""CPU ranks for the port's tensor- and data-parallel tests.

:class:`RankPool` spawns ``world`` processes that join one ``gloo`` process
group over ``localhost`` and then run tasks: a task is a function of this
module, called on every rank with the same arguments; the pool returns each
rank's result.  The workers import only torch and the port, never jax or the
test modules' JAX stack, so a test module computes the JAX side in its own
process and hands the numbers over as numpy.

A rank that raises fails the task: the pool reports its traceback, stops
every rank (the others may be waiting in a collective) and starts afresh on
the next task.
"""

from __future__ import annotations

import queue
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

TASK_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, tasks, results) -> None:
    torch.set_num_threads(1)
    from ct_diffusionmodelbench_tpu_torch.parallel import init_distributed

    try:
        init_distributed(f"localhost:{port}", world, rank, device="cpu")
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        item = tasks.get()
        if item is None:
            break
        name, args, kwargs = item
        try:
            out = globals()[name](*args, **kwargs)
            results.put((rank, True, out))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int = 4):
        self.world = world
        self.procs = []

    def _start(self):
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(self.world)]
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, self.world, port, self.tasks[r], self.results))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, *args, **kwargs) -> list:
        """``name(*args, **kwargs)`` on every rank; their results in rank
        order.  Raises with the failing rank's traceback."""
        if not self.procs:
            self._start()
        for q in self.tasks:
            q.put((name, args, kwargs))
        out = [None] * self.world
        try:
            for _ in range(self.world):
                rank, ok, value = self.results.get(timeout=TASK_TIMEOUT_S)
                if not ok:
                    raise RuntimeError(f"rank {rank} failed in {name}:\n{value}")
                out[rank] = value
        except (RuntimeError, queue.Empty):
            self.close(kill=True)
            raise
        return out

    def close(self, kill: bool = False):
        for p, q in zip(self.procs, getattr(self, "tasks", [])):
            if kill:
                p.kill()
            else:
                q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        self.procs = []


# ---------------------------------------------------------------------------
# Tasks (run on every rank)
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def rank_info(dp: int, tp: int):
    from ct_diffusionmodelbench_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=dp, model=tp)
    return dict(rank=mesh.rank, data_rank=mesh.data_rank,
                model_rank=mesh.model_rank, shape=mesh.shape,
                backend=mesh.backend)


def mesh_error(dp, tp, seq=1):
    """The error make_mesh raises for this layout, as (type name, message)."""
    from ct_diffusionmodelbench_tpu_torch.parallel import make_mesh

    try:
        make_mesh(data=dp, model=tp, seq=seq)
    except Exception as e:  # the test reads the type and message
        return type(e).__name__, str(e)
    return None


def sharded_forward(preset: str, params_np: dict, ids: np.ndarray, dp: int, tp: int,
                    mask=None, attn_impl="auto", **over):
    """The port's sharded forward at dp×tp on bridged weights: (logits,
    aux, the wq shard's shape)."""
    from ct_diffusionmodelbench_tpu_torch.io.bridge import shard_from_numpy
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.parallel import (
        make_mesh, make_sharded_forward)

    cfg = get_config(preset, dtype="float32", **over)
    mesh = make_mesh(data=dp, model=tp)
    params = shard_from_numpy(cfg, params_np, mesh)
    fwd = make_sharded_forward(cfg, mesh, attn_impl=attn_impl)
    with torch.inference_mode():
        logits, aux = fwd(params, torch.as_tensor(ids),
                          None if mask is None else torch.as_tensor(mask))
    return _np(logits), float(aux), tuple(params["blocks"]["wq"].shape)


def train_run(preset: str, params_np: dict, rows: list, dp: int, tp: int,
              out_dir: str, eval_rows=None, resume_from=None, **tc):
    """``Trainer.train()`` at dp×tp on bridged weights (``pad_token_id``
    0); with ``resume_from``, the optimizer state and step are read from
    that directory first.  Returns (each step's (loss, grad norm), the eval
    losses, the final status)."""
    from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config(preset, dtype="float32").replace(pad_token_id=0)
    params = params_from_numpy(params_np, device="cpu")
    trainer = Trainer(cfg, params, TrainConfig(output_dir=out_dir, dp=dp, tp=tp, **tc),
                      rows, eval_dataset=eval_rows, device="cpu")
    if resume_from is not None:
        trainer.load_training_state(resume_from)
    final = trainer.train()
    logs = [(e["loss"], e["grad_norm"]) for e in trainer.training_logs
            if "grad_norm" in e]
    evals = [e["eval_loss"] for e in trainer.training_logs if "eval_loss" in e]
    return logs, evals, final["status"]


def train_cli_shard(argv: list):
    """``cli/train.py``'s ``train_mesh`` then ``load_model`` on this rank:
    (its model rank, its shard's leaves as f32 numpy by flat name)."""
    from ct_diffusionmodelbench_tpu_torch.cli import train as train_cli
    from ct_diffusionmodelbench_tpu_torch.train.optim import flatten_params

    args = train_cli.build_parser().parse_args(argv)
    mesh = train_cli.train_mesh(args)
    _, params, _ = train_cli.load_model(args, mesh)
    return mesh.model_rank, {k: _np(v.float()) for k, v in flatten_params(params).items()}


def sharded_generate(preset: str, params_np: dict, prompts: np.ndarray,
                     dp: int, tp: int, **gen):
    """``llada_generate`` through ``make_sharded_forward``: token ids."""
    from ct_diffusionmodelbench_tpu_torch.io.bridge import shard_from_numpy
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.parallel import (
        make_mesh, make_sharded_forward)
    from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate

    cfg = get_config(preset, dtype="float32")
    mesh = make_mesh(data=dp, model=tp)
    params = shard_from_numpy(cfg, params_np, mesh)
    out = llada_generate(make_sharded_forward(cfg, mesh), params,
                         torch.as_tensor(prompts), mask_id=cfg.mask_token_id,
                         device="cpu", **gen)
    return _np(out)


def runner_generate(preset: str, params_np: dict, dp: int, tp: int,
                    texts=None, ids=None, **gen):
    """A sharded ``ModelRunner`` on bridged weights: ``generate`` of one
    text, ``generate_batch`` of several, or ``generate_ids``; returns
    [(token ids, text)] (texts empty for ids)."""
    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.io.bridge import shard_from_numpy
    from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.parallel import make_mesh

    cfg = get_config(preset, dtype="float32")
    tok = Tokenizer.byte_fallback(vocab_size=cfg.vocab_size, eos_token_id=2)
    mesh = make_mesh(data=dp, model=tp)
    runner = ModelRunner(cfg, shard_from_numpy(cfg, params_np, mesh), tok,
                         mesh=mesh, sharded=True)
    if ids is not None:
        return [(row, "") for row in runner.generate_ids(ids, **gen)]
    if isinstance(texts, str):
        r = runner.generate(texts, **gen)
        return [(r.token_ids, r.text)]
    return [(r.token_ids, r.text) for r in runner.generate_batch(texts, **gen)]


def cli_main(module: str, argv: list):
    """A CLI's ``main(argv)`` on every rank: what it printed."""
    import contextlib
    import importlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(f"ct_diffusionmodelbench_tpu_torch.cli.{module}").main(argv)
    return buf.getvalue()


def attention_piece(q, k, v, mask, dp: int, tp: int, split_heads: bool):
    """This rank's rows (and, when ``split_heads``, its share of the heads)
    of q/k/v through ``attention(..., impl="flash")`` under the mesh."""
    from ct_diffusionmodelbench_tpu_torch.ops.attention import attention
    from ct_diffusionmodelbench_tpu_torch.parallel import make_mesh, use_mesh

    mesh = make_mesh(data=dp, model=tp)
    b = q.shape[0]
    rows = mesh.rows(b) or slice(None)
    q, k, v, mask = (torch.as_tensor(t[rows]) for t in (q, k, v, mask))
    if split_heads:
        hq, hk = q.shape[2] // tp, k.shape[2] // tp
        m = mesh.model_rank
        q, k, v = q[:, :, m * hq:(m + 1) * hq], k[:, :, m * hk:(m + 1) * hk], \
            v[:, :, m * hk:(m + 1) * hk]
    with use_mesh(mesh, batch=b if dp > 1 else None):
        return _np(attention(q, k, v, mask, impl="flash"))


def runner_error(preset: str, dp: int, tp: int, **kw):
    """The error ``ModelRunner.random_init`` raises under the mesh."""
    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner

    try:
        ModelRunner.random_init(preset, dp=dp, tp=tp, device="cpu", **kw)
    except Exception as e:  # the test reads the type and message
        return type(e).__name__, str(e)
    return None


def forward_counts(preset: str, params_np: dict, dp: int, tp: int):
    """``parallel.comm.COUNTS`` around one sharded forward of 4 rows."""
    from ct_diffusionmodelbench_tpu_torch.parallel import comm

    comm.reset_counts()
    sharded_forward(preset, params_np, np.full((4, 16), 9), dp, tp)
    return dict(comm.COUNTS)
