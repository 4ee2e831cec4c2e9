"""The general generators, one per kind of traffic mix. A traffic mix
(gsbench/traffic/<mix>.json) names its kind and sets its parameters; the
kind's module here sets the program up, runs the measured window, and
works out the reference's side of `correct`.

Each kind's module has:
  setup(ctx) → state      the program built and warmed up; state.readings
                          holds what the comparison needs of it
  window(state, ctx) → dict   the measured window: attempted, failed,
                          units (steps or frames), visits {view: units},
                          t0, t1, and the end-to-end values
  reference(ctx, readings) → numbers   the comparison (compare.py)
  work(ctx, visits) → dict   the blend's work per unit, counted by the
                          reference (traced runs only)
"""
