"""Single-device training: AdamW, checkpoints and the trainer."""
