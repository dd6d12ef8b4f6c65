"""setup_s: seconds from the start of the run's process to the first timed
call: the program's import, the kernel library (built on a cell's first run
in a checkout), the instances, keys and index, and the warm-up calls."""


def read(run):
    return run["setup_s"]
