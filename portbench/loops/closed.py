"""A closed loop with one client: the next session starts when the last
has ended, in the caller's thread."""


def run(driver, order, seconds: float) -> tuple:
    """Sessions of `driver`, the items drawn from the iterator `order`,
    until a picture returns after `seconds`. Returns (sessions in start
    order, loop start, loop end)."""
    t0 = driver.clock()
    deadline = t0 + seconds
    out = []
    while True:
        name, unit = next(order)
        rec = driver.session(name, unit, deadline)
        out.append(rec)
        if rec["returns"] and rec["returns"][-1] > deadline or \
                driver.clock() > deadline:
            return out, t0, driver.clock()
