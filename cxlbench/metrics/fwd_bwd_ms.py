"""Milliseconds of ``loss_and_grad`` (forward, recomputing backward) on the
device: CUDA events recorded on the stream around the call, with no wait
for the card inside a step, the mean over the untraced stretch's steps."""


def read(run):
    ms = run.timed.get("fwd_bwd_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
