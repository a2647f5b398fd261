"""External flight controller for the lockstep example (a host-only copy
of ``examples/betaflight-sitl/controller.py``): a standalone UDP process
playing the betaflight-SITL role: it receives the vehicle state and
replies with the thrust command, in lockstep with the sim tick.

    python controller.py STATE_PORT CMD_PORT
"""

import socket
import struct
import sys

KP_ALT, KD_ALT = 8.0, 5.0
HOVER = 9.81  # thrust per unit mass at hover (sim accel = thrust - g)


def main() -> None:
    state_port = int(sys.argv[1]) if len(sys.argv) > 1 else 9103
    cmd_port = int(sys.argv[2]) if len(sys.argv) > 2 else 9104
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", state_port))
    sock.settimeout(30.0)
    while True:
        try:
            raw, _ = sock.recvfrom(65536)
        except socket.timeout:
            return
        tick, z, vz = struct.unpack_from("<Qdd", raw)
        thrust = HOVER + KP_ALT * (2.0 - z) - KD_ALT * vz
        thrust = max(0.0, min(thrust, 20.0))
        sock.sendto(
            struct.pack("<Qd", tick, thrust), ("127.0.0.1", cmd_port)
        )


if __name__ == "__main__":
    main()
