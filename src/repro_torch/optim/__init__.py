"""Optimizers: AdamW, its tiered form that pages state through the slow
tier (:mod:`repro_torch.optim.offload`), LR schedules and gradient
compression."""
