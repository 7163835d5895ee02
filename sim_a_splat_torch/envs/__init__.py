"""Environments: the functional pushT and manipulator envs, the task-space
wrapper, the splat observation wrapper and its asset-file construction,
batched over envs; the stateful one-env shells over them
(``single_env``); and the Gymnasium adapters, which are those shells with
their spaces.

The Gym classes (``gym_adapter``, ``manipulator_gym``, ``splat_gym``)
import ``gymnasium``, which the card's machine does not have, so this
package imports them only when one of their names is asked for.
"""

import importlib

_GYM = {
    "PushTEnv": "gym_adapter", "PushTImageEnv": "gym_adapter",
    "PushTKeypointsEnv": "gym_adapter", "register_envs": "gym_adapter",
    "ManipulatorEEFWrapper": "manipulator_gym",
    "ManipulatorSimEnv": "manipulator_gym",
    "SplatEnvWrapper": "splat_gym",
}


def __getattr__(name):
    if name in _GYM:
        module = importlib.import_module(f"{__name__}.{_GYM[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
