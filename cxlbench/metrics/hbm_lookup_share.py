"""Share of the window's lookups whose page lay in HBM, counted from the
page map the window ran on (``it.page_device``)."""


def read(run):
    issued, hits = run.timed["issued"], run.facts.get("hbm_lookups")
    if hits is None or not issued.sum():
        return None
    lookups = int(run.traffic["bags"]) * int(run.config["lookups_per_bag"])
    return float((issued * hits).sum() / (issued.sum() * lookups))
