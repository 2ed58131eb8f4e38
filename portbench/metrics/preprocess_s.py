"""Host preprocess (problem.py, program.py): the set-up's first solve's
Summary.preprocessor_time_in_seconds, which pays the Program's lowering."""


def read(ctx):
    return ctx.warm.preprocessor_time_in_seconds
