"""``setup_s``: the process's start to the first timed step (host clock):
imports, the card's context, the corpus, the program's set-up, the
checked steps and the warm-up."""


def read(ctx):
    return ctx.result.setup_s
