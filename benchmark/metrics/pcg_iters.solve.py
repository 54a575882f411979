"""pcg_iters.solve: PCG iterations a solve (``CGStats.cg_iterations``),
averaged over the window's solves."""


def read(data):
    its = data["window"].get("pcg_iters")
    return sum(its) / len(its) if its else None
