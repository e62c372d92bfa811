"""Prompt tokens (reused and computed) served in the window, over its
seconds: every request that ran in it, the one still running at the close
by the share of its submit that lay inside the window."""


def read(run):
    close = run.t0 + run.seconds
    done = 0.0
    for s in run.served:
        if s.ok and s.start < close:
            inside = min(s.end, close) - max(s.start, run.t0)
            done += s.req.prompt_len * inside / (s.end - s.start)
    return done / run.seconds
