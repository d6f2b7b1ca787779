from portbench.metrics._common import stage_ms


def read(obs):
    return stage_ms(obs, "backward")
