"""The BC-change corrector (the program's span ``time_loop.corrector``:
its setup, the operator apply of the velocity jump and its Krylov solve)
per load step, in ms.  The spans come in the stats of the window's Newton
solves (each solve's ``spans``: what the program's regions recorded since
the previous solve, so the corrector before it included)."""


def read(data):
    rows = [s["spans"].get("time_loop.corrector") for s in data["newton"]
            if "spans" in s]
    if not rows or not data.get("steps"):
        return None
    return 1e3 * sum(r["seconds"] for r in rows if r) / data["steps"]
