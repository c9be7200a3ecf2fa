# repro_torch: train-scan
"""Fixture: a round loop carrying only TrainState fields (clean)."""


def run(step, params, opt_state, astate, buf, num_rounds):
    rows = []
    for t in range(num_rounds):
        params, opt_state, astate, buf, row = step(params, opt_state,
                                                   astate, buf, t)
        rows.append(row)
    return params, opt_state, astate, buf, rows
