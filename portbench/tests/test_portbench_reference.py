"""The plain reference against the port on the tiny presets, on the CPU
(both float32: they agree to rounding)."""

import pytest
import torch

from portbench.harness import model
from portbench.reference import llada as ref
from portbench.tests.tiny import TINY_DENSE, TINY_MOE


def _preset_sizes(name):
    """The port's tiny preset as a configuration file would give it."""
    from ct_diffusionmodelbench_tpu_torch.models.config import get_config

    c = get_config(name)
    return {"name": name, "hidden_size": c.hidden_size, "num_hidden_layers": c.num_layers,
            "num_attention_heads": c.num_heads, "num_key_value_heads": c.num_kv_heads,
            "head_dim": c.head_dim, "intermediate_size": c.intermediate_size,
            "num_experts": c.num_experts, "num_experts_per_tok": c.num_experts_per_tok,
            "moe_intermediate_size": c.moe_intermediate_size,
            "num_shared_experts": c.num_shared_experts, "vocab_size": c.vocab_size,
            "rms_norm_eps": c.norm_eps, "rope_theta": c.rope_theta,
            "use_qk_norm": c.qk_norm, "mask_token_id": c.mask_token_id,
            "torch_dtype": c.dtype}


@pytest.mark.parametrize("conf", [_preset_sizes("llada-moe-tiny"), _preset_sizes("llada-tiny"),
                                  TINY_MOE, TINY_DENSE], ids=lambda c: c["name"])
def test_reference_logits_match_the_port(conf):
    from ct_diffusionmodelbench_tpu_torch.models.transformer import forward

    s = model.sizes(conf)
    dev = torch.device("cpu")
    cfg = model.port_config(s, dev)
    w = model.draw_weights(s, 2**40 + 3, dev)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(10, 400, (3, 24), generator=gen)
    mask = torch.ones_like(ids)
    mask[0, :5] = 0          # left padding
    mask[2, :11] = 0
    ids[:, 20:] = s["mask_token_id"]
    with torch.no_grad():
        mine, _ = forward(cfg, w, ids, attn_mask=mask, logit_start=16, logit_length=8)
    theirs = ref.block_logits(w, s, ids, mask, 16, 8)
    scale = theirs.abs().max()
    assert torch.allclose(mine, theirs, atol=1e-5 * scale, rtol=0)


def test_weights_repeat_for_a_seed_bit_for_bit():
    s = model.sizes(TINY_MOE)
    a = model.draw_weights(s, 7, torch.device("cpu"))
    b = model.draw_weights(s, 7, torch.device("cpu"))
    c = model.draw_weights(s, 8, torch.device("cpu"))
    assert torch.equal(a["blocks"]["we_up"], b["blocks"]["we_up"])
    assert not torch.equal(a["blocks"]["we_up"], c["blocks"]["we_up"])
    assert (a["lm_head"][:, s["mask_token_id"]] == 0).all()


def test_control_rounds_to_fp8_steps():
    from portbench.reference.control import fp8

    x = torch.randn(8, 64, generator=torch.Generator().manual_seed(1))
    y = fp8(x, -1)
    rel = ((y - x).abs() / x.abs().amax(dim=-1, keepdim=True)).max()
    assert 0 < rel <= 2.0 ** -4      # e4m3 keeps 3 bits of mantissa
    assert torch.equal(fp8(y, -1), y)
