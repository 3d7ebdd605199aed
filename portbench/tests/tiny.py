"""Tiny cells for the benchmark's CPU tests: the harness's files copied
into a scratch directory, with a tiny configuration and mix added as new
files, as a later change would add them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.harness import cells

TINY_MOE = {"name": "tiny-moe", "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
            "num_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 32,
            "num_shared_experts": 1, "vocab_size": 512, "rms_norm_eps": 1e-5,
            "rope_theta": 10000.0, "use_qk_norm": True, "mask_token_id": 500,
            "torch_dtype": "bfloat16", "reduced": [], "assumed": []}
TINY_DENSE = {"name": "tiny-dense", "d_model": 64, "n_layers": 2, "n_heads": 4,
              "n_kv_heads": 4, "mlp_hidden_size": 128, "vocab_size": 512,
              "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "mask_token_id": 500,
              "eos_token_id": 2, "torch_dtype": "bfloat16", "reduced": [], "assumed": []}
TINY_MIX = {"kind": "eval_decode", "why": "tiny", "batch": 4,
            "prompt_strata": [[10, 20], [21, 40], [41, 60], [61, 64]],
            "id_range": [10, 400], "bucket": 16, "runner": {},
            "generate": {"gen_length": 32, "steps": 16, "block_length": 8,
                         "temperature": 0.0, "remasking": "low_confidence"},
            "check": {"requests": 3, "steps_per_request": 6, "rows_per_forward": 4}}
TINY_SFT = {"kind": "sft", "why": "tiny", "seq_len": 64, "prompt_range": [8, 24],
            "id_range": [10, 400], "grad_accum": 2, "batch_size": 1, "learning_rate": 5e-3,
            "warmup_steps": 1, "total_steps": 100, "weight_decay": 0.01, "max_grad_norm": 1.0,
            "remat": True, "ce_chunk": 512, "optimizer_state_dtype": "int8",
            "grad_accum_dtype": "float32", "aux_loss_coef": 0.01, "check": {"steps": 3}}
# The program and the reference are both float32 on the CPU: a sound run
# agrees to rounding, far inside these.
TINY_LIMITS = {"limits": {"token_gap": 1e-3, "order_gap": 1e-3}}
TINY_SFT_LIMITS = {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}}
# The training and expert metrics, whose readers stand under metrics/ for
# the training and MoE cells that a later change adds; the tiny cells list
# them where BENCHMARK.json does not have them yet.
TRAIN = "train_tokens_per_s"
DECODE = "decode_tokens_per_s"
METRICS_NOT_YET_LISTED = {
    "end_to_end": [{"name": TRAIN, "unit": "tokens/s", "better": "higher", "bound": 0.2,
                    "source": "host_clock"}],
    "per_layer": [
        {"name": "grouped_ffn_roofline.decode", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "MoE", "moves": DECODE},
        {"name": "idle_share.train", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device", "moves": TRAIN},
        {"name": "busy_ms.train", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "device", "moves": TRAIN},
        {"name": "mfu.train", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "model step", "moves": TRAIN},
        {"name": "flash_bwd_roofline.train", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "attention", "moves": TRAIN},
        {"name": "optimizer_ms.train", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "trainer", "moves": TRAIN},
    ],
}


def base(tmp: Path) -> Path:
    """A copy of ``portbench/`` and ``BENCHMARK.json`` under ``tmp`` with
    the tiny cells ``tiny-{moe,dense}-{eval,sft}`` dropped in."""
    root = tmp / "checkout"
    shutil.copytree(cells.PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = cells.benchmark()
    for kind, metrics in METRICS_NOT_YET_LISTED.items():
        listed = {m["name"] for m in bench[kind]}
        bench[kind] += [dict(m, workloads=[]) for m in metrics if m["name"] not in listed]
    for conf in (TINY_MOE, TINY_DENSE):
        (root / "portbench" / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": conf["name"], "source": "tests",
                                 "file": f"portbench/configs/{conf['name']}.json",
                                 "reduced": [], "why": "tiny"})
    (root / "portbench" / "traffic" / "tiny-eval.json").write_text(json.dumps(TINY_MIX))
    for cname, conf in (("tiny-moe-eval", "tiny-moe"), ("tiny-dense-eval", "tiny-dense")):
        (root / "portbench" / "workloads" / f"{cname}.json").write_text(json.dumps(TINY_LIMITS))
        bench["workloads"].append({"name": cname, "config": conf, "traffic": "tiny-eval",
                                   "chips": 1, "why": "tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            decode = DECODE in (m["name"], m.get("moves"))
            experts = m["name"].startswith("grouped_ffn")
            if decode and "workloads" in m and (conf == "tiny-moe" or not experts):
                m["workloads"].append(cname)
    (root / "portbench" / "traffic" / "tiny-sft.json").write_text(json.dumps(TINY_SFT))
    for cname, conf in (("tiny-moe-sft", "tiny-moe"), ("tiny-dense-sft", "tiny-dense")):
        (root / "portbench" / "workloads" / f"{cname}.json").write_text(
            json.dumps(TINY_SFT_LIMITS))
        bench["workloads"].append({"name": cname, "config": conf, "traffic": "tiny-sft",
                                   "chips": 1, "why": "tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            train = TRAIN in (m["name"], m.get("moves"))
            if train and "workloads" in m:
                m["workloads"].append(cname)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root / "portbench"
