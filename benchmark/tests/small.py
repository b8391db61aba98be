"""A cell's configuration cut to a grid a CPU test can hold."""


def patch(config: dict, grid=(24, 24, 12)) -> dict:
    flags = list(config["ij_flags"])
    i = flags.index("-n")
    flags[i + 1:i + 4] = [str(g) for g in grid]
    return {"ij_flags": flags, "grid": list(grid)}
