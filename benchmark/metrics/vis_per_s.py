"""vis_per_s (vis/s, higher): visibilities passed through every request
the window completed, divided by the window's length on the host clock.
An image of N records counts N, and a prediction of N records counts N.
Every cell."""


def read(m):
    return m.vis_done / m.window_s
