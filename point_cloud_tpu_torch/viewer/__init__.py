"""The viewer application of the port: streaming + camera + rendering,
headless (counterpart of viewer/__init__.py): ``Viewer.update`` runs the
per-frame control plane on the host, ``Viewer.render`` the frame on the
card, and ``offscreen`` writes frames as PNG (``render_orbit``);
``window`` runs it in a Tk window, ``interactive`` converts clouds into
it frame by frame.
"""

from .app import Viewer, ViewerInput  # noqa: F401
