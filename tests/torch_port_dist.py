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
        return self.run_beside(lambda: None, name, *args, **kwargs)[1]

    def run_beside(self, local, name: str, *args, **kwargs) -> tuple:
        """(``local()``, :meth:`run`'s results): the ranks run the task
        while this process computes ``local()``."""
        if not self.procs:
            self._start()
        for q in self.tasks:
            q.put((name, args, kwargs))
        try:
            mine = local()
        except BaseException:
            self.close(kill=True)
            raise
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
        return mine, out

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


def rank_info(dp: int, tp: int, seq: int = 1, stages: int = 1):
    """This rank's coordinates on the mesh, and the ranks of its seq or
    stage group, as an all-gather over that group sees them."""
    from ct_diffusionmodelbench_tpu_torch.parallel import make_mesh
    from ct_diffusionmodelbench_tpu_torch.parallel.comm import all_gather
    from ct_diffusionmodelbench_tpu_torch.parallel.pipeline import make_pp_mesh

    mesh = (make_pp_mesh(stages, data=dp, model=tp) if stages > 1
            else make_mesh(data=dp, model=tp, seq=seq))
    group = mesh.seq_group if seq > 1 else mesh.stage_group
    mid = (None if group is None else
           all_gather(torch.tensor([[mesh.rank]]), group, mesh, dim=1)[0].tolist())
    return dict(rank=mesh.rank, data_rank=mesh.data_rank,
                model_rank=mesh.model_rank, seq_rank=mesh.seq_rank,
                stage_rank=mesh.stage_rank, shape=mesh.shape,
                backend=mesh.backend, mid_group=mid)


def mesh_error(dp, tp, seq=1):
    """The error make_mesh raises for this layout, as (type name, message)."""
    from ct_diffusionmodelbench_tpu_torch.parallel import make_mesh

    try:
        make_mesh(data=dp, model=tp, seq=seq)
    except Exception as e:  # the test reads the type and message
        return type(e).__name__, str(e)
    return None


def sharded_forward(preset: str, params_np: dict, ids: np.ndarray, dp: int, tp: int,
                    mask=None, attn_impl="auto", seq=1, logit_start=None,
                    logit_length=None, **over):
    """The port's sharded forward at dp×tp (×seq) on bridged weights:
    (logits, aux, the wq shard's shape)."""
    from ct_diffusionmodelbench_tpu_torch.io.bridge import shard_from_numpy
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.parallel import (
        make_mesh, make_sharded_forward)

    cfg = get_config(preset, dtype="float32", **over)
    mesh = make_mesh(data=dp, model=tp, seq=seq)
    params = shard_from_numpy(cfg, params_np, mesh)
    fwd = make_sharded_forward(cfg, mesh, attn_impl=attn_impl)
    with torch.inference_mode():
        logits, aux = fwd(params, torch.as_tensor(ids),
                          None if mask is None else torch.as_tensor(mask),
                          logit_start=logit_start, logit_length=logit_length)
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


def train_cli_stage_shard(argv: list):
    """As :func:`train_cli_shard` under ``--pp``: (this rank's (stage,
    model) coordinates, its shard's leaves as f32 numpy by flat name)."""
    from ct_diffusionmodelbench_tpu_torch.cli import train as train_cli
    from ct_diffusionmodelbench_tpu_torch.train.optim import flatten_params

    args = train_cli.build_parser().parse_args(argv)
    mesh = train_cli.train_mesh(args)
    _, params, _ = train_cli.load_model(args, mesh)
    return ((mesh.stage_rank, mesh.model_rank),
            {k: _np(v.float()) for k, v in flatten_params(params).items()})


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


def ring_piece(q, k, v, mask, dp: int, sp: int, tp: int, impl="auto",
               split=True, grad=False):
    """This rank's rows, positions (``split``) and heads (over ``model``) of
    q/k/v through ``attention(..., impl)`` under a dp×sp×tp mesh; with
    ``grad``, the gradients of Σ tanh(out) over every rank's piece.
    Returns the rank's coordinates, its output, its gradients and the
    collectives it issued."""
    from ct_diffusionmodelbench_tpu_torch.ops.attention import attention
    from ct_diffusionmodelbench_tpu_torch.parallel import comm, make_mesh, use_mesh

    mesh = make_mesh(data=dp, model=tp, seq=sp)
    b, s = q.shape[:2]
    rows = mesh.rows(b) or slice(None)
    pos = mesh.seq_slice(s) if split else slice(None)
    hq, hk, m = q.shape[2] // tp, k.shape[2] // tp, mesh.model_rank
    q, k, v = (torch.as_tensor(t[rows][:, pos][:, :, m * h:(m + 1) * h]).requires_grad_(grad)
               for t, h in ((q, hq), (k, hk), (v, hk)))
    mask = None if mask is None else torch.as_tensor(mask[rows][:, pos])
    comm.reset_counts()
    with torch.set_grad_enabled(grad), use_mesh(
            mesh, batch=b if dp > 1 else None, seq_len=s if split else None):
        out = attention(q, k, v, mask, impl=impl)
        if grad:
            torch.tanh(out).sum().backward()
    return dict(coords=(mesh.data_rank, mesh.seq_rank, mesh.model_rank),
                out=_np(out), counts=dict(comm.COUNTS),
                grads=tuple(_np(t.grad) for t in (q, k, v)) if grad else None)


def pp_forward(preset: str, params_np: dict, ids: np.ndarray, stages: int,
               micro: int, dp: int = 1, tp: int = 1, mask=None, grad=False,
               **over):
    """The port's GPipe forward on bridged weights: (logits, aux, this
    rank's (stage, model) coordinates, with ``grad`` the gradients of
    mean(tanh(logits[..., :64])) by flat name, this rank's shards)."""
    from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.parallel.pipeline import (
        make_pp_forward, make_pp_mesh, shard_params_pp)
    from ct_diffusionmodelbench_tpu_torch.train.optim import flatten_params

    cfg = get_config(preset, dtype="float32", **over)
    mesh = make_pp_mesh(stages, data=dp, model=tp)
    params = shard_params_pp(cfg, params_from_numpy(params_np, device="cpu"), mesh)
    flat = flatten_params(params)
    for t in flat.values():
        t.requires_grad_(grad)
    pp = make_pp_forward(cfg, mesh, micro)
    with torch.set_grad_enabled(grad):
        logits, aux = pp(params, torch.as_tensor(ids),
                         None if mask is None else torch.as_tensor(mask))
        if grad:
            torch.tanh(logits[..., :64]).mean().backward()
    grads = {k: _np(t.grad) for k, t in flat.items()} if grad else None
    return _np(logits), float(aux.detach()), (mesh.stage_rank, mesh.model_rank), grads


def gathered_where(preset: str, params_np: dict, dp: int, tp: int, **tc):
    """Which parts of the full tree ``Trainer._gathered`` (the save's
    gather) leaves on this rank: (params held, optimizer state held)."""
    from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config(preset, dtype="float32")
    rows = [{"input_ids": [5] * 8, "prompt_lengths": 1}]
    tr = Trainer(cfg, params_from_numpy(params_np, device="cpu"),
                 TrainConfig(dp=dp, tp=tp, **tc), rows, device="cpu")
    params, state = tr._gathered()
    return params is not None, state is not None


def train_steps(preset: str, params_np: dict, batches: list, **tc):
    """``Trainer.train_step`` on explicit batches and noise ``[(ids [A, B,
    L], prompt lengths [A, B], t [A, B], u [A, B, L])]`` under the mesh
    ``tc`` asks for: each step's (loss, grad norm)."""
    from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
    from ct_diffusionmodelbench_tpu_torch.models import get_config
    from ct_diffusionmodelbench_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config(preset, dtype="float32")
    rows = [{"input_ids": [5] * 8, "prompt_lengths": 1}]
    tr = Trainer(cfg, params_from_numpy(params_np, device="cpu"), TrainConfig(**tc),
                 rows, device="cpu")
    out = []
    for ids, plens, t, u in batches:
        _, tr.opt_state, m = tr.train_step(tr.params, tr.opt_state,
                                           torch.as_tensor(ids).long(),
                                           torch.as_tensor(plens).long(),
                                           (torch.as_tensor(t), torch.as_tensor(u)))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out
