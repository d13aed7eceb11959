"""recall_at_10: over the seeded sample of the window's answers, the share
of the exact answer's top-10 ids that the served top-10 holds."""


def read(rec):
    return rec["check"]["recall"]
