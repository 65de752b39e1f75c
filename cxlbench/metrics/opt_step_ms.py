"""Milliseconds of the optimizer step (``adamw.apply`` or
``TieredAdamW.step``) on the device: CUDA events recorded on the stream
around the call, with no wait for the card inside a step, the mean over
the untraced stretch's steps."""


def read(run):
    ms = run.timed.get("opt_step_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
