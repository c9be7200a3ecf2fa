# repro_torch: train-scan
"""Fixture: a round loop carrying state past TrainState (RV106 x2)."""


def run(step, params, opt_state, staleness_buffer, carry, num_rounds):
    for t in range(num_rounds):
        params, opt_state = step(params, opt_state, t)
        staleness_buffer, carry["lr"] = step(staleness_buffer, carry, t)
    return params, opt_state
