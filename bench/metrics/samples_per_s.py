"""Samples whose logits reached the host inside the window, over the
time from the window's start to the last of them (host clock): all the
work the window completed, over the time it took, with no share of a
batch still in flight counted on either side."""


def read(run):
    if not run.span_s:
        return None
    return run.samples / run.span_s
