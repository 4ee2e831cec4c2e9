"""The lazy trainer's resort (fold back, frame plan, extract), timed by
the harness's span around each `resort` call with the device
synchronised at both ends, mean over the traced window, in ms. Moves
train_step_ms."""


def read(art):
    d = art["spans"].get("resort")
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
