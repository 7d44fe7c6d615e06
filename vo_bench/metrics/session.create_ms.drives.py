"""session.create_ms.drives: the harness's span around each session's
`create_frontend` in the window, mean a session (ms)."""


def read(run):
    if not run.create_ms:
        return None
    return sum(run.create_ms) / len(run.create_ms)
