"""Loading, making the inputs, building and warming up (s)."""


def read(rec):
    return rec["setup_s"]
