"""The matrix products of one DQN iteration (MLP Q-head, obs -> hidden
-> hidden -> actions): the actor's forward on one observation an env,
the online forward on the batch and its backward (every weight's
gradient, and the input gradient of all but the first layer), and the
target's forward on the batch.  2 operations a multiply-add."""

OBS_DIM, N_ACTIONS = 4, 2


def counts(config: dict, cell: dict) -> dict:
    h, b, e = config["hidden"], config["batch"], config["num_envs"]
    dims = [(OBS_DIM, h), (h, h), (h, N_ACTIONS)]
    fwd = sum(2 * a * c for a, c in dims)        # a row
    input_grads = sum(2 * a * c for a, c in dims[1:])
    return {"flops": e * fwd + b * (3 * fwd + input_grads), "bytes": 0}
