"""Share of the span batch's device busy time launched under the program's
``sampler.select`` spans: the sampler's own work in each denoising step
(the EOS mask, scoring, confidence, the transfer schedule, top-k or
threshold, the write-back), outside the model's call.  The program's spans
joined to the device trace by launch: ``portbench/harness/spans.py``."""


def read(run):
    sl = getattr(run, "span_slice", None)
    if sl is None or sl.busy_s <= 0 or "sampler.select" not in sl.spans:
        return None
    return 100.0 * sl.seconds("sampler.select") / sl.busy_s
