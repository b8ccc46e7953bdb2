"""Keys sorted host to host per second of the window (host clock)."""


def read(run):
    return run.items_per_s()
