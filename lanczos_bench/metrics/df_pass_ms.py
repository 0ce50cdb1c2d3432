"""df_pass_ms: device time of one df64 alpha/beta pass,
``lanczos_alphabeta_df(dg, x_hi, x_lo, k)``, from the all-ones start, by
CUDA events over back-to-back calls.  Nothing to read outside df64."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "Lanczos loop", "query_ms.df64"


def read(run):
    if run.traffic["precision"] != "df64":
        return None
    import torch
    from tpu_lanczos_torch.core.lanczos_df import lanczos_alphabeta_df

    dg, k = run.dg, int(run.traffic["kwargs"]["k"])
    hi = dg.realmask.reshape(-1).to(torch.float32)
    lo = torch.zeros_like(hi)
    return run.device_ms(lambda: lanczos_alphabeta_df(dg, hi, lo, k))
