"""Kernel launches of the view chain per view: the sum of every kernel
wrapper's ``launches`` counter over the window, over the window's views."""


def read(window):
    return sum(window.launches.values()) / window.views if window.views else None
