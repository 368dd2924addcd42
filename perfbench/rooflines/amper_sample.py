"""``amper_sample_kernel`` (``csrc/amper_sample.cu``), one call: the
whole AMPER-fr draw of one table.  Every row read once (4 B code, 1 B
live flag), the m ranges read, the batch of int32 rows and the four
int32 statistics written.  No arithmetic worth a bound."""


def counts(config: dict, cell: dict) -> dict:
    n, m, b = config["replay_size"], config["amper_m"], config["batch"]
    return {"bytes": n * 5 + m * 8 + b * 4 + 16, "flops": 0}
