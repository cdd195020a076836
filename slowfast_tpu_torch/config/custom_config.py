"""Extension hook for downstream forks to register extra config keys.

Mirrors reference slowfast/config/custom_config.py:1-9.
"""


def add_custom_config(_C):
    # Add your own customized configs here.
    pass
