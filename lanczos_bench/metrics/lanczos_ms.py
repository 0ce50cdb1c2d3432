"""lanczos_ms: device time of one float32 ``lanczos(dg, x, k)`` on the
cell's pack from the all-ones start (the pack's realmask), by CUDA events
over back-to-back calls.  Nothing to read in a cell that is not float32."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "Lanczos loop", "query_ms"


def read(run):
    if run.traffic["precision"] != "float32":
        return None
    from tpu_lanczos_torch.core.lanczos import lanczos

    dg, k = run.dg, int(run.traffic["kwargs"]["k"])
    x = dg.realmask.reshape(-1).clone()
    return run.device_ms(lambda: lanczos(dg, x, k))
