"""Serving CLI: an HTTP front end over GroundingPredictor and MicroBatcher.

    python -m stcat_tpu_torch.cli.serve --config-file experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml \\
        --port 8765 MODEL.WEIGHT out/run

One long-lived process per card holds the weights on the device and
micro-batches concurrent requests (``--max-batch`` lanes per forward, each
request waiting at most ``--max-wait-ms`` for lane-mates). It serves on
``cuda`` unless ``--device`` names another device. Protocol (stdlib on both
ends):

  GET  /healthz   -> {"status": "ok", "model", "resolution", "max_batch",
                      "frame_buckets"}
  POST /predict   body: an .npz archive (numpy.savez) with
       frames     uint8 [T, H, W, 3] RGB              (required)
       text       0-d unicode array, the query        (required)
       frame_ids  int array [T], original frame ids   (optional)
    -> {"boxes": {frame_id: [x1, y1, x2, y2]}, "span": [start, end]}
       boxes in original pixels, the span in frame_ids units.

A body that does not parse, or an input the predictor refuses, answers 400;
an unknown path 404; any other failure 500. Client sketch:

    buf = io.BytesIO(); np.savez(buf, frames=clip, text=np.array(query))
    conn = http.client.HTTPConnection(host, port)
    conn.request("POST", "/predict", buf.getvalue())

ThreadingHTTPServer gives each request in flight its own thread; all of them
submit to the one MicroBatcher.
"""

from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import add_common_args, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="STCAT serving (PyTorch)")
    add_common_args(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--max-batch", type=int, default=2,
                   help="requests per micro-batch (two device lanes each)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="longest wait of a request for lane-mates")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def _make_handler(batcher, info):
    import numpy as np

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass  # one access line per request would swamp the log at serving rates

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", **info})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                with np.load(io.BytesIO(self.rfile.read(n))) as z:
                    frames = z["frames"]
                    text = str(z["text"])
                    fids = z["frame_ids"].tolist() if "frame_ids" in z else None
            except Exception as e:  # boundary: any unreadable body is the client's fault
                self._reply(400, {"error": f"bad request body: {e}"})
                return
            try:
                res = batcher.submit(frames, text, fids).result(timeout=600)
            except ValueError as e:  # the predictor's input checks
                self._reply(400, {"error": str(e)})
                return
            except Exception as e:  # boundary: the server keeps serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {
                "boxes": {int(fid): [float(v) for v in np.asarray(box).reshape(-1)]
                          for fid, box in res["boxes"].items()},
                "span": [int(res["span"][0]), int(res["span"][1])],
            })

    return Handler


def build_server(cfg, host, port, max_batch, max_wait_ms, logger=None, device=None):
    """(server, batcher): the predictor loaded and warmed up by one request
    of the largest frame bucket (on the card that request also builds the
    kernels when ``_build/`` lacks them), the batcher over it, and the HTTP
    server bound to (host, port), not yet serving."""
    import numpy as np

    from ..serve import GroundingPredictor, MicroBatcher

    pred = GroundingPredictor(cfg, logger=logger, max_batch=max_batch, device=device)
    t_max = int(max(cfg.TPU.FRAME_BUCKETS))
    pred.predict(np.zeros((min(2 * t_max, 2 * cfg.INPUT.MAX_VIDEO_LEN), 64, 64, 3), np.uint8),
                 "warmup")
    batcher = MicroBatcher(pred, max_wait_ms=max_wait_ms)
    info = {"model": cfg.MODEL.VISION_BACKBONE.NAME, "resolution": cfg.INPUT.RESOLUTION,
            "max_batch": max_batch, "frame_buckets": list(cfg.TPU.FRAME_BUCKETS)}
    server = ThreadingHTTPServer((host, port), _make_handler(batcher, info))
    return server, batcher


def main(argv=None):
    args = parse_args(argv)
    from ..core.logging import setup_logger
    from ..ops.misc import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config_file, args.opts)
    logger = setup_logger("stcat_tpu_torch", cfg.OUTPUT_DIR)
    server, batcher = build_server(cfg, args.host, args.port, args.max_batch, args.max_wait_ms,
                                   logger, device)
    logger.info(f"serving on {args.host}:{server.server_address[1]} "
                f"(max_batch={args.max_batch}, wait={args.max_wait_ms} ms, {device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.close()
        server.server_close()


if __name__ == "__main__":
    main()
