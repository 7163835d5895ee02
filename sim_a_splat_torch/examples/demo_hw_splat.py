"""Hardware-mirror demo: external joint states drive the splat env.

The port of ``examples/demo_hw_splat.py`` (the reference's ROS 2 digital
twin): joint states in degrees get per-joint sign and offset compensation
and step the splat env, a real robot mirrored into the scene.  Sources:

- ``--ros``: a ROS 2 ``rclpy`` subscription to ``/joint_state`` (``rclpy``
  imported only then; it needs a sourced ROS 2 environment);
- default: a UDP listener on ``--port`` taking JSON arrays of joint angles
  in degrees (``echo '[10,0,0,0,0,0]' | nc -u localhost 9870``);
- ``--replay N``: N steps of a synthetic joint-state stream.

The arm's base sits on the reference demo's non-identity weld.

    python -m sim_a_splat_torch.examples.demo_hw_splat --replay 20
"""

from __future__ import annotations

import argparse
import json
import socket

import numpy as np

from sim_a_splat_torch import resolve_device
from sim_a_splat_torch.examples.common import (
    NUM_DOF, add_device_option, log, make_manipulator_splat_env,
)

# hw interface compensation (reference demo_hw_splat.py:26-27)
DEFAULT_JOINT_STATE = np.zeros(NUM_DOF)
JOINT_SIGNS = np.array([-1, 1, -1, 1, 1, 1], dtype=np.float64)[:NUM_DOF]
BASE_WELD = ((1.0, 0.0, 0.0, 0.0), (0.65, -1.23, 0.42))


def create_splat_env(device="cuda", render_size=(240, 320)):
    env = make_manipulator_splat_env(eef=False, render_size=render_size,
                                     weld_frame_transform=BASE_WELD,
                                     device=device)
    env.reset(reset_to_state={
        "robot_pos": DEFAULT_JOINT_STATE,
        "block_pos": [0.0, 0.0, 0.0, 0.0],
        "goal_pos": [0.0, 0.0, 0.0, 0.0],
    })
    return env


def compensate(msg_data) -> np.ndarray:
    """Degrees → compensated radians (reference :113-119)."""
    joint_states = np.asarray(msg_data, np.float64) * np.pi / 180.0
    return joint_states * JOINT_SIGNS + DEFAULT_JOINT_STATE


def joint_state_callback(msg_data, env) -> None:
    """One joint-state message → an env step (no camera observation)."""
    joint_states = compensate(msg_data)
    env.step(joint_states, noobs=True)
    log(f"mirrored q = {np.round(joint_states, 3)}")


def replay_message(t: int, replay: int) -> np.ndarray:
    """Message ``t`` of the synthetic ``replay``-step stream (degrees)."""
    return 25.0 * np.sin(2 * np.pi * t / replay + np.arange(NUM_DOF))


def listen_ros(env) -> None:
    try:
        import rclpy
        from rclpy.node import Node
        from std_msgs.msg import Float32MultiArray
    except ImportError as e:
        raise ImportError(
            "rclpy is required for --ros. Source the ROS 2 environment "
            "before running this script.") from e
    rclpy.init(args=None)
    node = Node("splat_mirror_node")
    node.get_logger().info("Joint state listener node initialized")
    node.create_subscription(
        Float32MultiArray, "/joint_state",
        lambda msg: joint_state_callback(msg.data, env), 10)
    rclpy.spin(node)


def listen_udp(env, port: int) -> None:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", port))
    log(f"listening for JSON joint states (degrees) on udp://127.0.0.1:{port}")
    try:
        while True:
            data, _ = sock.recvfrom(65536)
            try:
                joint_state_callback(json.loads(data.decode()), env)
            except (ValueError, KeyError) as e:
                log(f"bad packet: {e}")
    finally:
        sock.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ros", action="store_true",
                   help="use a ROS 2 /joint_state topic")
    p.add_argument("--port", default=9870, type=int, help="UDP port (non-ROS)")
    p.add_argument("--replay", default=0, type=int,
                   help="steps of a synthetic stream instead of listening")
    add_device_option(p)
    args = p.parse_args(argv)
    env = create_splat_env(resolve_device(args.device))
    if args.replay > 0:
        for t in range(args.replay):
            joint_state_callback(replay_message(t, args.replay), env)
    elif args.ros:
        listen_ros(env)
    else:
        listen_udp(env, args.port)


if __name__ == "__main__":
    main()
