"""K1's share of its roofline, in percent: the least time the card could
take for the traced tail's K1 launches (`harness/k1.bound_s`: the larger
of the bytes each launch's shapes need over the HBM rate and 2 x 256
operations per pair passing its gates over the int8 rate) over their device
time in the profiler's kernel records (`gated_best2`). The passing pairs
are counted by the reference's gate arithmetic on the traced frames'
snapshotted inputs, after the window. A traced step whose count of K1
kernels differs from the reference's count of searches (a Sim3 stage's
launches, say) is left out."""
LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNEL = "gated_best2"


def read(run):
    from benchmark.harness import k1
    tail = run.profile
    if tail is None:
        return None
    bound = time = 0.0
    for (start, end), snaps in zip(tail.steps, run.trace_snaps):
        if not snaps:
            continue
        work = run.entry.k1_work(run.reference, snaps)
        kern = tail.kernels(KERNEL, within=(start, end))
        if len(kern) != len(work) or not work:
            continue
        bound += sum(k1.bound_s(b, p) for b, p in work)
        time += sum(e - s for s, e in kern) / 1e6
    return 100.0 * bound / time if time > 0 else None
