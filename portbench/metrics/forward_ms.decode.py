"""Device milliseconds of one model call in the span batch: the device time
launched under the program's ``model.forward`` spans over its
``model.forward`` counter (one a call).  A device-time rate: the host's
speed does not enter it, so it tells the program's change from the
machine's."""


def read(run):
    sl = getattr(run, "span_slice", None)
    if (sl is None or sl.busy_s <= 0 or not sl.counters.get("model.forward")
            or "model.forward" not in sl.spans):
        return None
    return 1e3 * sl.seconds("model.forward") / sl.counters["model.forward"]
