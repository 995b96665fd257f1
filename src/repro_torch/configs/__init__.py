"""Network configurations of the port: ``--arch`` ids -> modules with
``FULL`` and ``SMOKE``."""
from . import csnn_paper, csnn_wide

ARCHS = {"csnn-paper": csnn_paper, "csnn-wide": csnn_wide}
