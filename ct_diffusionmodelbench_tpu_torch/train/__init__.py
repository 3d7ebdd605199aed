"""Masked-diffusion SFT: collator, loss, optimizer, train step and trainer."""
