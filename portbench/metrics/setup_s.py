"""setup_s: seconds from the process's start to the window's opening:
``import torch``, inputs, the program's builds and index set-up, warm-up."""


def read(rec):
    return rec["setup_s"]
