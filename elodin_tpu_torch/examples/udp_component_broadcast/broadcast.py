"""Broadcast components from a local elodin-db over UDP.

Parity: fsw/udp_component_broadcast/broadcast_component.py — subscribe to
components from a source DB and UDP-broadcast them at a controlled rate so a
second simulation instance (possibly on another machine) can mirror them.
The reference discovers interface broadcast addresses via netifaces; this
rebuild takes explicit --target addresses (use the subnet broadcast address,
or a unicast peer), which also keeps the loopback test deterministic.

    python -m elodin_tpu_torch.examples.udp_component_broadcast.broadcast \
        --db-addr 127.0.0.1:2240 \
        --component bdx.world_pos --rename target.world_pos \
        --rate 20 --target 255.255.255.255:41235

A copy of the JAX example's ``broadcast.py`` as a package module: it imports the
port's ``db`` and, inside ``main``, the generated protobuf module.
"""

import argparse
import socket
import sys
import time

from ...db import Client


def main(argv=None):
    from . import component_broadcast_pb2 as pb

    p = argparse.ArgumentParser()
    p.add_argument("--db-addr", default="127.0.0.1:2240")
    p.add_argument("--component", action="append", required=True,
                   help="component name to broadcast (repeatable)")
    p.add_argument("--rename", action="append", default=[],
                   help="destination name, matched by position")
    p.add_argument("--rate", type=float, default=20.0, help="Hz")
    p.add_argument("--target", action="append", required=True,
                   help="host:port to send to (repeatable; use the subnet "
                        "broadcast address for one-to-many)")
    p.add_argument("--source-id", default="sim")
    p.add_argument("--max-samples", type=int, default=None,
                   help="stop after N datagrams (for tests)")
    p.add_argument("--heartbeat-every", type=int, default=20,
                   help="send a heartbeat every N sample rounds")
    args = p.parse_args(argv)

    renames = dict(zip(args.component, args.rename))
    targets = []
    for t in args.target:
        host, _, port = t.rpartition(":")
        targets.append((host, int(port)))

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)

    client = Client.connect(args.db_addr)
    info = client.components()
    missing = [c for c in args.component if c not in info]
    if missing:
        sys.exit(f"components not in source DB: {missing}")

    seq = dict.fromkeys(args.component, 0)
    sent = 0
    period = 1.0 / args.rate
    rounds = 0
    try:
        while args.max_samples is None or sent < args.max_samples:
            t0 = time.monotonic()
            for name in args.component:
                sample = client.latest(name)
                if sample is None:
                    continue
                ci = info[name]
                d = pb.Datagram()
                d.sample.source_id = args.source_id
                d.sample.component = name
                d.sample.rename = renames.get(name, "")
                d.sample.timestamp_us = sample.timestamp_us
                d.sample.prim = ci.prim
                d.sample.shape.extend(int(s) for s in ci.shape)
                d.sample.data = sample.values.tobytes()
                d.sample.sequence = seq[name]
                seq[name] += 1
                payload = d.SerializeToString()
                for tgt in targets:
                    sock.sendto(payload, tgt)
                sent += 1
                if args.max_samples is not None and sent >= args.max_samples:
                    break
            rounds += 1
            if rounds % args.heartbeat_every == 0:
                hb = pb.Datagram()
                hb.heartbeat.source_id = args.source_id
                hb.heartbeat.components.extend(args.component)
                hb.heartbeat.rate_hz = args.rate
                hb.heartbeat.timestamp_us = time.time_ns() // 1000
                for tgt in targets:
                    sock.sendto(hb.SerializeToString(), tgt)
            time.sleep(max(0.0, period - (time.monotonic() - t0)))
    except KeyboardInterrupt:
        pass
    finally:
        client.close()
        sock.close()
    print(f"broadcast {sent} samples")


if __name__ == "__main__":
    main()
