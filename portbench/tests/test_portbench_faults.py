"""The comparison at work: a sound tiny run is correct; the fp8 control
and each fault a decode cell can have, planted in the timed path, come out
not correct.  (The program's and the reference's weights are both float32
on the CPU, so the tiny cells' limits sit far below the control.)"""

import numpy as np
import pytest
import torch

from portbench.harness import cells, decode_check, model, seeds, traffic
from portbench.harness.runtime import Run, run_cell
from portbench.reference import llada as ref
from portbench.reference.control import fp8
from portbench.tests.tiny import TINY_LIMITS, base


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    return base(tmp_path_factory.mktemp("pb"))


def _run(pb, cell="tiny-moe-eval", seed=11):
    return run_cell(cells.cell(cell, base=pb), seed, 0.3, False, torch.device("cpu"), 0.0,
                    base=pb)


@pytest.mark.parametrize("cell", ["tiny-moe-eval", "tiny-dense-eval"])
def test_sound_runs_are_correct(pb, cell):
    for seed in (1, 2**35 + 1):
        out = _run(pb, cell, seed)
        assert out["correct"], out["checks"]
        assert out["checks"]["structure"]["value"] == 0


def test_a_step_that_leaves_its_state_unchanged_fails(pb, monkeypatch):
    from ct_diffusionmodelbench_tpu_torch.sampling import llada

    monkeypatch.setattr(llada, "rank_topk_mask", lambda c, k: torch.zeros_like(c, dtype=torch.bool))
    out = _run(pb)
    assert not out["correct"] and out["checks"]["structure"]["value"] > 0
    assert out["failed"] == out["attempted"]


def test_a_token_altered_where_it_is_produced_fails(pb, monkeypatch):
    from ct_diffusionmodelbench_tpu_torch.sampling import llada

    monkeypatch.setattr(llada, "gumbel_rescore", lambda logits, t, g=None: logits.roll(7, dims=-1))
    out = _run(pb)
    assert not out["correct"]
    assert out["checks"]["token_gap"]["value"] > TINY_LIMITS["limits"]["token_gap"]


def test_half_of_the_batch_left_out_fails(pb, monkeypatch):
    from ct_diffusionmodelbench_tpu_torch.eval import runner as runner_mod

    real = runner_mod.llada_generate

    def half(fwd, params, prompt, **kw):
        """Decodes the first half of the rows; the rest keep their masks."""
        h = prompt.shape[0] // 2
        mask = kw.pop("attn_mask")
        out = real(fwd, params, prompt[:h], attn_mask=mask[:h], **kw)
        rest = torch.full((prompt.shape[0] - h, out.shape[1]), kw["mask_id"],
                          dtype=out.dtype, device=out.device)
        rest[:, :prompt.shape[1]] = prompt[h:].to(out.device)
        return torch.cat([out, rest])

    monkeypatch.setattr(runner_mod, "llada_generate", half)
    out = _run(pb)
    assert not out["correct"] and out["failed"] >= out["attempted"] // 2


def test_a_sampler_that_leaves_the_seam_stops_the_run(pb, monkeypatch):
    """The decode check reads each step at ``ModelRunner.forward_fn``; a
    sampler that calls the model another way stops the run with an error
    that names the seam, rather than reading as not correct."""
    from ct_diffusionmodelbench_tpu_torch.eval import runner as runner_mod

    real = runner_mod.llada_generate

    def around(fwd, *a, **kw):
        return real(getattr(fwd, "__self__", fwd).inner, *a, **kw)

    monkeypatch.setattr(runner_mod, "llada_generate", around)
    with pytest.raises(RuntimeError, match="forward_fn"):
        _run(pb)


def test_the_fp8_control_fails_the_limits(pb):
    """The control's readings at the tiny size: the reference in fp8 put
    in the program's place, at the program's states."""
    cell = cells.cell("tiny-moe-eval", base=pb)
    drv = cells.driver("eval_decode", pb)
    dev = torch.device("cpu")
    for seed in (4, 5, 6):
        run = Run(cell=cell, seed=seed, seconds=0, trace=False, device=dev, t0=0.0)
        s, runner, rec = drv.build(run)
        b = next(traffic.prompt_batches(cell.traffic, seed, s["mask_token_id"]))
        out = runner.generate_ids(b.ids, attn_mask=b.mask,
                                  **drv.decode_kw(cell.traffic))
        trajs, lengths = drv.trajectories([(b, out, rec.take())], dev)
        pairs = decode_check.sample(trajs, lengths, cell.traffic,
                                    seeds.host_rng(seed, seeds.SAMPLE))
        w = model.draw_weights(s, seed, dev)
        worst, _ = decode_check.judge(trajs, pairs, w, s, cell.traffic, control=fp8)
        limits = TINY_LIMITS["limits"]
        assert worst["token_gap"] <= limits["token_gap"]
        assert worst["control_token_gap"] > limits["token_gap"] or \
            worst["control_order_gap"] > limits["order_gap"]


def test_schedule_spreads_the_masks():
    assert decode_check.schedule(32, 16) == [2] * 16
    assert decode_check.schedule(5, 3) == [2, 2, 1]
    assert np.sum(decode_check.schedule(31, 4)) == 31


def _sft(pb, cell="tiny-moe-sft", seed=21):
    return run_cell(cells.cell(cell, base=pb), seed, 0.3, False, torch.device("cpu"), 0.0,
                    base=pb)


@pytest.mark.parametrize("cell", ["tiny-moe-sft", "tiny-dense-sft"])
def test_sound_training_runs_are_correct(pb, cell):
    for seed in (3, 2**34 + 9):
        out = _sft(pb, cell, seed)
        assert out["correct"], out["checks"]
        assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_a_training_step_that_leaves_its_state_unchanged_fails(pb, monkeypatch):
    from ct_diffusionmodelbench_tpu_torch.train import optim

    monkeypatch.setattr(optim.AdamWLowp, "update",
                        lambda self, g, st, p, n: optim.AdamWState(st.count + 1, st.mu, st.nu))
    out = _sft(pb)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_training_batch_left_out_fails(pb, monkeypatch):
    from ct_diffusionmodelbench_tpu_torch.train import trainer

    real = trainer.make_train_step

    def halved(*a, **kw):
        step, ev = real(*a, **kw)

        def half(params, state, ids, plens, noise):
            h = ids.shape[0] // 2
            return step(params, state, ids[:h], plens[:h], (noise[0][:h], noise[1][:h]))
        return half, ev

    monkeypatch.setattr(trainer, "make_train_step", halved)
    out = _sft(pb)
    assert not out["correct"] and out["checks"]["loss_gap"]["value"] > 1e-2


def test_training_tokens_altered_where_they_are_made_fail(pb, monkeypatch):
    from ct_diffusionmodelbench_tpu_torch.train import collator

    real = collator.DiffusionCollator.__call__

    def altered(self, features, train=True):
        out = real(self, features, train)
        out["input_ids"] += 1
        return out

    monkeypatch.setattr(collator.DiffusionCollator, "__call__", altered)
    out = _sft(pb)
    assert not out["correct"]
