"""What the per-layer readers share: each reads the traced run's
observations (``portbench.harness.Observations``) and returns a value, or
``None`` where there is nothing to read."""

from portbench import counts, trace

# K1's kernel (persia_tpu_torch/csrc/embedding_bag.cu), as the profiler
# names it
K1 = r"\bbag_kernel\b"


def idle_share(obs):
    """The device's idle share of the traced window, in percent."""
    if obs.trace is None or obs.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - obs.trace["busy_s"] / obs.trace["window_s"])


def k1_roofline(obs):
    """K1's share of its bound, in percent: its device time a step from
    the trace against the bytes the traced steps' lookups need."""
    if obs.trace is None:
        return None
    seconds, launches = trace.seconds_of(obs.trace["kernels"], K1)
    if launches == 0:
        return None
    nbytes = counts.k1_bytes(round(obs.ids_traced), round(obs.rows_traced),
                             obs.batch, obs.a)
    return 100.0 * counts.bound_s(nbytes) / (seconds / obs.steps)


def step_mfu(obs):
    """The tower's model FLOPs at the traced window's rate, in percent of
    the bfloat16 peak."""
    if obs.trace is None or obs.trace["window_s"] <= 0:
        return None
    flops = counts.tower_flops(obs.a, obs.train) * obs.batch * obs.steps
    return 100.0 * flops / obs.trace["window_s"] / counts.PEAK_BF16_FLOPS


def stage_ms(obs, stage):
    """A stage's milliseconds a step, synchronized after each stage."""
    if obs.stage_s is None or not obs.sync_steps:
        return None
    return 1e3 * obs.stage_s[stage] / obs.sync_steps


def optimizer_roofline(obs):
    """The Adagrad update's share of its bound, in percent: the bytes a
    step's update needs over the optimizer stage's time."""
    ms = stage_ms(obs, "optimizer")
    if not ms:
        return None
    nbytes = counts.adagrad_bytes(round(obs.rows_synced), obs.a)
    return 100.0 * counts.bound_s(nbytes) / (ms / 1e3)
