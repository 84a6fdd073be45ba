"""Online serving: microbatching HTTP server + client round trip.

Starts an AlignServer in-process, sends concurrent requests, and shows the
batching stats. In production run `python -m versalignlib_tpu.serve` and
put a load balancer in front of one server per GPU.
"""

import http.client
import json
import threading

from versalignlib_tpu import AlignmentEngine, AlignServer, BatchingAligner

aligner = BatchingAligner(AlignmentEngine(), max_wait_ms=10)
with AlignServer(aligner, port=0) as server:
    server.start()
    host, port = server.address

    def post(path, body):
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("POST", path, body=json.dumps(body))
        out = json.loads(conn.getresponse().read())
        conn.close()
        return out

    results = {}

    def client(i):
        results[i] = post("/v1/score", {
            "reads": ["ACGTACGTAC"] * 4, "refs": ["TTACGTACGTACTT"] * 4,
            "algorithm": "sw"})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print("scores per request:", {i: r["scores"][0] for i, r in
                                  sorted(results.items())})
    print("alignment:", post("/v1/align", {
        "reads": ["ACGTACGTAC"], "refs": ["TTACGTACGTACTT"]})
        ["alignments"][0]["cigar"])
    print("mapping:", post("/v1/map", {
        "reads": ["ACGTACGTAC"], "panel": ["TTACGTACGTACTT", "GGGGGGGG"]})
        ["hits"][0])

    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request("GET", "/stats")
    stats = json.loads(conn.getresponse().read())
    conn.close()
    print(f"{stats['requests']} requests coalesced into "
          f"{stats['batches']} device batches")
