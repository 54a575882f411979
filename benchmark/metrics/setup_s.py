"""setup_s: seconds from the start of the run's process to the window:
imports, the kernels' build where none is cached, the inputs, the upload
and the warm-up."""


def read(data):
    return data["setup_s"]
