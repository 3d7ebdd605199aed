"""Share of the span batch's device busy time launched under the program's
``model.forward`` spans by operations that are neither GEMM nor attention
kernels (``portbench/harness/spans.py``'s classes): the model's norms,
activations, casts, residual adds, rotations and copies."""


def read(run):
    sl = getattr(run, "span_slice", None)
    if sl is None or sl.busy_s <= 0 or "model.forward" not in sl.spans:
        return None
    return 100.0 * sl.seconds("model.forward", "other") / sl.busy_s
