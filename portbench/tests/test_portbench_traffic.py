"""The traffic generator: deterministic in the seed, inside its ranges."""

import json

import numpy as np

from portbench.harness import cells, traffic

MIXES = ["eval-b8", "eval-b4"]


def _mix(name):
    return json.loads((cells.PORTBENCH / "traffic" / f"{name}.json").read_text())


def _first(mix, seed, n=5, mask_id=156895):
    gen = traffic.prompt_batches(mix, seed, mask_id)
    return [next(gen) for _ in range(n)]


def test_prompt_batches_repeat_for_a_seed_and_differ_across_seeds():
    mix = _mix("eval-b8")
    a, b, c = _first(mix, 2**33 + 7), _first(mix, 2**33 + 7), _first(mix, 2**33 + 8)
    for x, y in zip(a, b):
        assert np.array_equal(x.ids, y.ids) and np.array_equal(x.mask, y.mask)
        assert x.lengths == y.lengths
    assert any(not np.array_equal(x.ids, z.ids) for x, z in zip(a, c))


def test_prompt_lengths_lie_in_their_strata_and_pad_to_one_bucket():
    for name in MIXES:
        mix = _mix(name)
        for b in _first(mix, 12345, n=20):
            for n, (lo, hi) in zip(sorted(b.lengths), mix["prompt_strata"]):
                assert lo <= n <= hi
            # Every batch pads to the longest bucket: the same work a seed.
            assert b.ids.shape == (mix["batch"], 576)
            for r, n in enumerate(b.lengths):
                assert b.mask[r].sum() == n and b.mask[r, -n:].all()
                real = b.ids[r, -n:]
                lo, hi = mix["id_range"]
                assert real.min() >= lo and real.max() < hi


def test_ids_never_take_the_mask_id():
    mix = dict(_mix("eval-b8"), id_range=[10, 13])
    for b in _first(mix, 3, n=10, mask_id=11):
        assert not (b.ids[b.mask == 1] == 11).any()


def test_sft_rows_differ_and_keep_their_ranges():
    mix = {"seq_len": 64, "prompt_range": [8, 20], "id_range": [10, 400]}
    rows = traffic.sft_rows(mix, 99, 6, mask_id=500)
    assert rows == traffic.sft_rows(mix, 99, 6, mask_id=500)
    assert len({tuple(r["input_ids"]) for r in rows}) == 6
    for r in rows:
        assert len(r["input_ids"]) == 64 and 8 <= r["prompt_lengths"] <= 20
