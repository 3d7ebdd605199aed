"""Share of the traced batch's device busy time launched under the
program's ``sdar.commit`` spans: the SDAR sampler's store passes, each a
forward of a finished block that writes its final K and V into the cache
(no LM head).  The part of the decode a commit fused into the next block's
first step would remove."""


def read(run):
    sl = getattr(run, "span_slice", None)
    if sl is None or sl.busy_s <= 0 or "sdar.commit" not in sl.spans:
        return None
    return 100.0 * sl.seconds("sdar.commit") / sl.busy_s
