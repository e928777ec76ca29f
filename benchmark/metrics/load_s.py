"""load_s: host seconds to read the saved artifact (``cli.load_packed``)
and upload it to the card, in runs that load one."""


def read(ctx):
    spans = ctx["spans"]
    if "load" not in spans:
        return None
    return spans["load"] + spans["upload"]
