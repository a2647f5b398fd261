"""Receive UDP component broadcasts and write them into a local elodin-db.

Parity: fsw/udp_component_broadcast/receive_broadcast.py — listens for
`ComponentSample` datagrams, tracks per-component sequence numbers to count
packet loss, and writes the (optionally renamed) component into the
destination DB so a second simulation can follow entities from the first.

    python -m elodin_tpu_torch.examples.udp_component_broadcast.receive \
        --listen 0.0.0.0:41235 --db-addr 127.0.0.1:2240

A copy of the JAX example's ``receive.py`` as a package module: it imports the
port's ``db`` and, inside ``main``, the generated protobuf module.
"""

import argparse
import socket

import numpy as np

from ...db import Client, Field
from ...db.vtable import PRIM_NP


def main(argv=None):
    from . import component_broadcast_pb2 as pb

    p = argparse.ArgumentParser()
    p.add_argument("--listen", default="0.0.0.0:41235")
    p.add_argument("--db-addr", default="127.0.0.1:2240")
    p.add_argument("--max-samples", type=int, default=None,
                   help="stop after N samples (for tests)")
    p.add_argument("--timeout", type=float, default=None)
    args = p.parse_args(argv)

    host, _, port = args.listen.rpartition(":")
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, int(port)))
    if args.timeout:
        sock.settimeout(args.timeout)
    print(f"listening on {args.listen}", flush=True)  # readiness signal

    client = Client.connect(args.db_addr)
    writers: dict[str, object] = {}
    last_seq: dict[str, int] = {}
    lost = 0
    written = 0
    try:
        while args.max_samples is None or written < args.max_samples:
            try:
                data, _ = sock.recvfrom(65536)
            except socket.timeout:
                break
            d = pb.Datagram()
            d.ParseFromString(data)
            if d.WhichOneof("kind") != "sample":
                continue
            s = d.sample
            key = f"{s.source_id}/{s.component}"
            prev = last_seq.get(key)
            if prev is not None and s.sequence > prev + 1:
                lost += s.sequence - prev - 1
            last_seq[key] = s.sequence
            name = s.rename or s.component
            value = np.frombuffer(s.data, dtype=PRIM_NP[s.prim]).reshape(
                tuple(s.shape) or ()
            )
            w = writers.get(name)
            if w is None:
                spec = Field(s.prim)
                if s.shape:
                    spec = spec[tuple(s.shape)]
                w = client.table_writer({name: spec})
                writers[name] = w
            w.write(s.timestamp_us, {name: value})
            written += 1
    except KeyboardInterrupt:
        pass
    finally:
        for w in writers.values():
            w.close()
        client.close()
        sock.close()
    print(f"received {written} samples ({lost} lost)")


if __name__ == "__main__":
    main()
