"""page_loop.pass_edge_ms: ms of a document pass in which the card holds
none of its work: from the start of a ``keraslm.rate.workspace`` span to
the end of its first ``keraslm.rate.launch``, and from the end of its
last ``keraslm.fetch`` to its own end; the mean over the passes that lie
wholly in the window."""
from portbench import spans


def read(job):
    if job.trace is None:
        return None
    launches = spans.ranges(job.trace, 'rate.launch', clip=False)
    fetches = spans.ranges(job.trace, 'fetch', clip=False)
    edges = []
    for s, e in spans.ranges(job.trace, 'rate.workspace', clip=False):
        if s < job.trace.t0 or e > job.trace.t1:
            continue
        first = [le for ls, le in launches if s <= ls and le <= e]
        last = [fe for fs, fe in fetches if s <= fs and fe <= e]
        if first and last:
            edges.append((min(first) - s) + (e - max(last)))
    if not edges:
        return None
    return 1e-6 * sum(edges) / len(edges)
