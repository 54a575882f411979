"""solve_s: the window's wall seconds over the solves it completed, each
ended by a synchronise."""


def read(data):
    n = data["window"].get("solves", 0)
    return data["window_s"] / n if n else None
