"""The MoE routing before the expert kernels (``ops/grouped_gemm_cuda.py``:
``router_topk``, its chain ``router_topk_plain`` and G4's wrapper
``router_topk_cuda``; ``routed_layout`` and G5's wrapper
``routed_layout_cuda``), on the CPU.

- ``routed_layout``'s CPU path (``counting_layout``, ``gather_rows`` and
  ``valid_tiles``) against the layout built slot by slot in Python: each
  expert's slots in slot order from its group's first row, every group
  rounded up to whole tiles, the dropped group of expert parallelism last,
  a tile past the experts' rows named by the last expert, pad rows holding
  token 0.  Cases: many slots of one expert among others (ties of the
  rank), empty experts, one expert holding every slot, ``drop_foreign``,
  and both row tiles (64, and 128 from 65536 slots up).
- The router's chain puts tied probabilities in the order of their expert.
- G4's backward, ``router_topk_backward`` (written out so that the card
  launches G4 under grad too), gives the chain's autograd gradient of the
  logits bit for bit, with and without the renormalisation, with a
  cotangent on the top-k probabilities, on the full ones (the aux loss) or
  on both, on tied logits too.
- A CPU tensor launches nothing.
- G4's and G5's wrappers check shapes, dtypes and sizes before the device,
  so their refusals show here; that they refuse a CPU tensor at all, too.
  Their arithmetic, bit-equal to the chains run on the card, is held there
  (``tests/test_torch_port_cuda.py``).
- No kernel of ``csrc/moe_route.cu`` reads as a product or an expert FFN
  kernel to the benchmark's readers.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
from ct_diffusionmodelbench_tpu_torch.models import moe
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _layout_by_slot(idx, e, tile_m, drop):
    """(dest, tile_expert, sizes [e], tile_valid, m_pad) as lists, one slot
    at a time."""
    groups = e + 1 if drop else e
    flat = idx.reshape(-1).tolist()
    m_pad = gg.padded_rows(len(flat), groups, tile_m)
    sizes = [flat.count(g) for g in range(groups)]
    starts, ends, row = [], [], 0
    for size in sizes:
        starts.append(row)
        row += -(-size // tile_m) * tile_m
        ends.append(row)
    taken = [0] * groups
    dest = []
    for g in flat:
        dest.append(starts[g] + taken[g])
        taken[g] += 1
    tile_expert, valid = [], []
    for t in range(m_pad // tile_m):
        te = min(sum(end <= t * tile_m for end in ends), e - 1)
        tile_expert.append(te)
        valid.append(int(t * tile_m < starts[te] + sizes[te]))
    return dest, tile_expert, sizes[:e], valid, m_pad


def _ids(case, g):
    """(topk_idx [N, K], e, drop_foreign) of a layout case."""
    if case == "ties":
        return torch.randint(0, 8, (37, 4), generator=g), 8, False
    if case == "empty_experts":
        pick = torch.tensor([0, 5, 15])
        return pick[torch.randint(0, 3, (29, 3), generator=g)], 16, False
    if case == "one_expert":
        return torch.full((23, 2), 3), 8, False
    if case == "drop_foreign":   # experts 8-15 live on another rank: slot id 8
        idx = torch.randint(0, 16, (41, 4), generator=g)
        return torch.where(idx < 8, idx, torch.full_like(idx, 8)), 8, True
    # 65536 slots: the layout takes 128-row tiles.
    return torch.randint(0, 64, (8192, 8), generator=g), 64, False


@pytest.mark.parametrize("case", ["ties", "empty_experts", "one_expert", "drop_foreign",
                                  "tile_m_128"])
def test_routed_layout_cpu_is_the_slot_by_slot_layout(case):
    g = torch.Generator().manual_seed(len(case))
    idx, e, drop = _ids(case, g)
    n, k = idx.shape
    tile_m = gg.layout_tile_m(n * k)
    assert tile_m == (128 if case == "tile_m_128" else 64)
    x = torch.randn((n, 8), generator=g)
    reset_launch_counts()
    xs, dest, tile_expert, sizes, valid = gg.routed_layout(x, idx, e, tile_m, drop)
    assert KERNELS["moe_layout"].launches == 0
    m_pad = gg.padded_rows(n * k, e + 1 if drop else e, tile_m)
    want_dest, want_te, want_sizes, want_valid, want_m_pad = _layout_by_slot(idx, e, tile_m,
                                                                            drop)
    assert m_pad == want_m_pad and xs.shape == (m_pad, 8)
    assert dest.dtype == torch.int64 and dest.tolist() == want_dest
    assert tile_expert.dtype == sizes.dtype == valid.dtype == torch.int32
    assert tile_expert.tolist() == want_te
    assert sizes.tolist() == want_sizes
    assert valid.tolist() == want_valid
    assert torch.equal(xs[dest], x.repeat_interleave(k, dim=0))
    pad = torch.ones(m_pad, dtype=torch.bool)
    pad[dest] = False
    assert torch.equal(xs[pad], x[:1].expand(int(pad.sum()), -1))
    if case == "empty_experts":
        assert sizes.tolist().count(0) == 13
    if case == "drop_foreign":
        foreign = dest.reshape(n, k)[idx == e]
        assert foreign.numel() > 0
        assert not valid[foreign // tile_m].any()


def test_router_chain_orders_ties_by_expert():
    """Equal probabilities keep the order of their experts, as
    ``jax.lax.top_k``'s; the renormalised top-k sums to one."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0],
                           [0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                           [2.0, -1.0, 2.0, 4.0, 2.0, 4.0]])
    for norm in (False, True):
        probs, idx, full = gg.router_topk(logits, 4, norm)
        assert idx.tolist() == [[1, 2, 4, 5], [0, 1, 2, 3], [3, 5, 0, 2]]
        assert torch.equal(full, torch.softmax(logits, dim=-1))
        if norm:
            assert torch.allclose(probs.sum(dim=-1), torch.ones(3))
        else:
            assert torch.equal(probs, full.gather(1, idx))


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("used", ["topk", "full", "both"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_topk_backward_is_the_chains_autograd(norm, used, ties):
    g = torch.Generator().manual_seed(7 + 2 * norm + ties)
    n, e, k = 33, 64, 8
    if ties:
        logits = torch.randint(-3, 4, (n, e), generator=g).float() * 0.5
    else:
        logits = torch.randn((n, e), generator=g) * 2
    logits.requires_grad_(True)
    topk_probs, idx, full = gg.router_topk_plain(logits, k, norm)
    g_topk = torch.randn((n, k), generator=g) if used != "full" else torch.zeros((n, k))
    g_full = torch.randn((n, e), generator=g) if used != "topk" else torch.zeros((n, e))
    parts = [(topk_probs * g_topk).sum()] if used != "full" else []
    parts += [(full * g_full).sum()] if used != "topk" else []
    (want,) = torch.autograd.grad(sum(parts), logits)
    got = gg.router_topk_backward(full.detach(), idx, norm, g_topk, g_full)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no_norm"])
def test_topk_function_takes_its_backward(monkeypatch, norm):
    """The autograd wrapper the card runs under grad, with its forward (G4)
    stood in for by the chain: the router's weight gets the chain's own
    gradient from the renormalised top-k and from the aux loss, and the
    indices carry none."""
    monkeypatch.setattr(gg, "router_topk_cuda", gg.router_topk_plain)
    g = torch.Generator().manual_seed(11)
    x = torch.randn((40, 32), generator=g)
    w = torch.randn((32, 16), generator=g).requires_grad_(True)
    g_topk = torch.randn((40, 4), generator=g)
    grads = []
    for fn in (gg._RouterTopk.apply, gg.router_topk_plain):
        probs, idx, full = fn(x @ w, 4, norm)
        assert not idx.requires_grad
        loss = (probs * g_topk).sum() + moe.load_balancing_loss(full, idx, 16)
        grads.append(torch.autograd.grad(loss, w)[0])
    assert grads[0].abs().max() > 0 and torch.equal(grads[0], grads[1])


def test_routed_layout_plain_is_the_cpu_path():
    g = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 16, (41, 4), generator=g)
    idx = torch.where(idx < 8, idx, torch.full_like(idx, 8))
    x = torch.randn((41, 16), generator=g)
    got = gg.routed_layout(x, idx, 8, 64, True)
    want = gg.routed_layout_plain(x, idx, 8, 64, True)
    assert len(got) == len(want) == 5
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cpu_routing_launches_nothing():
    cfg = get_config("llada-moe-tiny", dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    lp = {name: w[0] for name, w in params["blocks"].items()}
    x = torch.randn((20, cfg.hidden_size), generator=torch.Generator().manual_seed(2))
    reset_launch_counts()
    probs, idx, full = moe.router_probs(x, lp["router"], cfg.num_experts_per_tok,
                                        cfg.norm_topk_prob)
    gg.routed_layout(x, idx, cfg.num_experts)
    out, _ = moe.moe_block(x, lp, top_k=cfg.num_experts_per_tok,
                           norm_topk=cfg.norm_topk_prob)
    assert out.shape == x.shape
    assert KERNELS["moe_topk"].launches == KERNELS["moe_layout"].launches == 0
    want = gg.router_topk_plain(x @ lp["router"], cfg.num_experts_per_tok,
                                cfg.norm_topk_prob)
    assert all(torch.equal(a, b) for a, b in zip((probs, idx, full), want))


LOGITS = torch.zeros((6, 16))


@pytest.mark.parametrize("logits,top_k,match", [
    (LOGITS.double(), 2, r"float32 \[N, E\]"),
    (LOGITS.bfloat16(), 2, r"float32 \[N, E\]"),
    (LOGITS[0], 2, r"float32 \[N, E\]"),
    (torch.zeros((6, 1025)), 2, "1 to 1024 experts"),
    (LOGITS, 0, r"top_k must lie in \[1, 16\]"),
    (LOGITS, 17, r"top_k must lie in \[1, 16\]"),
    (torch.zeros((6, 64)), 33, r"top_k must lie in \[1, 32\]"),
    (LOGITS, 2, "CUDA"),
], ids=["f64", "bf16", "1d", "e_1025", "k_0", "k_past_e", "k_33", "cpu"])
def test_topk_cuda_refuses_before_the_device(logits, top_k, match):
    with pytest.raises(ValueError, match=match):
        gg.router_topk_cuda(logits, top_k, True)


X = torch.zeros((6, 64), dtype=torch.bfloat16)
IDX = torch.zeros((6, 2), dtype=torch.int64)


@pytest.mark.parametrize("x,idx,e,tile_m,drop,match", [
    (X[0], IDX, 8, 64, False, r"\[N, D\]"),
    (X.half(), IDX, 8, 64, False, "x has dtype"),
    (X[:, :60], IDX, 8, 64, False, "16-byte words"),
    (X, IDX.int(), 8, 64, False, "topk_idx must be int64"),
    (X, IDX[:5], 8, 64, False, "topk_idx must be int64"),
    (X, IDX[:, 0], 8, 64, False, "topk_idx must be int64"),
    (X, torch.zeros((6, 65), dtype=torch.int64), 8, 64, False, "1 to 64 slots"),
    (X, IDX, 512, 64, True, "1 to 512 groups"),
    (X, IDX, 0, 64, False, "1 to 512 groups"),
    (X, IDX, 8, 0, False, "tile_m must be positive"),
    (X, IDX, 8, 64, False, "CUDA"),
], ids=["x_1d", "x_f16", "row_120_bytes", "idx_int32", "idx_short", "idx_1d", "k_65",
        "groups_513", "e_0", "tile_m_0", "cpu"])
def test_layout_cuda_refuses_before_the_device(x, idx, e, tile_m, drop, match):
    with pytest.raises(ValueError, match=match):
        gg.routed_layout_cuda(x, idx, e, tile_m, drop)


def _metric_module(name):
    path = REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_route_kernel_names_read_as_neither_product_nor_expert_ffn():
    """G4's (both modes) and G5's kernels hold none of the GEMM metric's patterns and none
    of the roofline readers' kernel names, so a profile counts them in
    none of those metrics."""
    src = (REPO / "ct_diffusionmodelbench_tpu_torch" / "csrc" / "moe_route.cu").read_text()
    names = set(re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(", src))
    assert names == {"ctdb_moe_topk_kernel", "ctdb_moe_topk_sigmoid_kernel",
                     "ctdb_moe_layout_count_kernel",
                     "ctdb_moe_layout_scan_kernel", "ctdb_moe_layout_gather_kernel"}
    gemm = _metric_module("dense_gemm_roofline.decode")
    kernels = [kname for metric in ("grouped_ffn_roofline.decode", "flash_fwd_roofline.decode",
                                    "cache_attn_roofline.decode", "flash_bwd_roofline.train")
               for kname in _metric_module(metric).KERNELS]
    for name in names:
        shown = f"void {name}<4>(float const*, long long*, int)"
        assert not any(p in shown for p in gemm.PATTERNS)
        assert not any(kname in shown for kname in kernels)
