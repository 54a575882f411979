"""device_idle.solve: the share of the window, in %, in which no
operation ran on the card (``torch.profiler``, CUDA activity only)."""


def read(data):
    dev = data.get("device")
    if not dev or data["window_s"] <= 0 or dev["ops"] == 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / data["window_s"])
