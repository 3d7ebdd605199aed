"""Device milliseconds of one denoising step of the SDAR sampler in the
traced batch: the device time launched under the program's ``sdar.step``
spans (the block's pass against the cache and the sampler's selection)
over its ``sdar.steps`` counter.  A device-time rate: the host's speed
does not enter it."""


def read(run):
    sl = getattr(run, "span_slice", None)
    if sl is None or not sl.counters.get("sdar.steps") or "sdar.step" not in sl.spans:
        return None
    return 1e3 * sl.seconds("sdar.step") / sl.counters["sdar.steps"]
