"""Bytes the exchange plan put on the wire per key sorted: the program's
``exchange_bytes_on_wire`` counter, a count from shapes."""


def read(run):
    return run.counter_per_item("exchange_bytes_on_wire")
