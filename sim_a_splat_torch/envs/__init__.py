"""Functional environments: the manipulator env, its task-space wrapper and
the splat observation wrapper, batched over envs."""
