"""The example drivers on the port: the JAX package's ``examples/`` demos
run through ``sim_a_splat_torch`` on the card (or on the CPU when asked).

Each demo runs as ``python -m sim_a_splat_torch.examples.<demo>`` with the
reference demo's options plus ``--device`` (default ``cuda``):

- ``demo_pusht_splat``: a pushT task (scripted headless, mouse teleop with
  ``pygame`` interactively) drives the arm's end effector in the splat
  scene;
- ``demo_joint_sliders_splat``: a scripted slider sweep of the joints, or
  slider lines on stdin;
- ``demo_hw_splat``: joint states from a replayed stream, a UDP listener or
  ROS 2 mirrored into the scene through a non-identity base weld;
- ``demo_viewer``: the scene served to a browser, one slider a joint.

They build the gym-free one-env shells of ``envs/single_env.py``
(``common.make_manipulator_splat_env``), so neither ``gymnasium`` nor ``click`` is needed; ``pygame`` and ``rclpy``
are imported only by the interactive and ROS modes.  Without a card a demo
raises unless ``--device cpu`` is passed.
"""
