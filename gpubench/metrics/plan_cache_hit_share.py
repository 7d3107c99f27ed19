"""Host planner: the share of the window's plan-cache lookups that found
the segment prepared (the program's ``render.plan_cache.hit`` and
``.miss`` counters)."""


def read(ctx):
    rep = ctx['report']
    hits = rep.get('render.plan_cache.hit', (0.0, 0))[1]
    misses = rep.get('render.plan_cache.miss', (0.0, 0))[1]
    if not hits + misses:
        return None
    return hits / (hits + misses)
