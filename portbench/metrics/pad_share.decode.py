"""Share of the positions the runner decodes that are padding, in the span
batch: 100 · the program's ``runner.pad_positions`` counter (the zeros of
the attention mask it is handed) over its ``runner.positions`` (B · the
padded prompt and generated length).  Every forward pass runs the padded
rows whole."""


def read(run):
    sl = getattr(run, "span_slice", None)
    if sl is None or not sl.counters.get("runner.positions"):
        return None
    return 100.0 * sl.counters.get("runner.pad_positions", 0) / sl.counters["runner.positions"]
