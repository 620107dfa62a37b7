"""RabbitMQ suite — queue semantics under partitions.

Reference: rabbitmq/src/jepsen/rabbitmq.clj + test/jepsen/rabbitmq_test.clj:
a queue client (enqueue/dequeue/drain with publisher confirms,
rabbitmq.clj:102-183) checked with checker/queue (unordered-queue model)
+ checker/total-queue, under partition-random-halves with a long
fault cadence and a final per-process drain (rabbitmq_test.clj:46-80).

The AMQP client is gated on the `pika` library; the db automation,
workload, generator, and checker wiring are complete and unit-tested.
"""

from __future__ import annotations

import itertools
import logging
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                fixtures, generator as gen, nemesis)
from ..checker import basic
from ..os import debian

log = logging.getLogger("jepsen")

QUEUE = "jepsen.queue"


class RabbitDB:
    """apt install + clustering via rabbitmqctl (rabbitmq.clj db)."""

    def setup(self, test, node):
        from .. import core as core_mod

        sess = control.session(node, test)
        debian.install(sess, ["rabbitmq-server"])
        su = sess.su()
        su.exec("service", "rabbitmq-server", "start")
        primary = core_mod.primary(test)
        if node != primary:
            su.exec("rabbitmqctl", "stop_app")
            su.exec("rabbitmqctl", "join_cluster",
                    f"rabbit@{primary}")
            su.exec("rabbitmqctl", "start_app")

    def teardown(self, test, node):
        su = control.session(node, test).su()
        try:
            su.exec("rabbitmqctl", "stop_app")
            su.exec("rabbitmqctl", "reset")
        except control.RemoteError:
            pass


def db() -> RabbitDB:
    return RabbitDB()


class QueueClient(client_mod.Client):
    """enqueue/dequeue/drain over AMQP with publisher confirms
    (rabbitmq.clj:102-183)."""

    def __init__(self, node=None):
        self.node = node
        self.conn = None
        self.channel = None

    def open(self, test, node):
        try:
            import pika
        except ImportError as e:
            raise RuntimeError(
                "the rabbitmq suite's client needs the pika library; "
                "pip install pika on the control node") from e
        c = QueueClient(node)
        c.conn = pika.BlockingConnection(
            pika.ConnectionParameters(host=str(node)))
        c.channel = c.conn.channel()
        c.channel.confirm_delivery()
        c.channel.queue_declare(queue=QUEUE, durable=True)
        return c

    def invoke(self, test, op):
        from ..codec import decode, encode

        if op.f == "enqueue":
            import pika

            self.channel.basic_publish(
                exchange="", routing_key=QUEUE, body=encode(op.value),
                properties=pika.BasicProperties(delivery_mode=2),
                mandatory=True)
            return replace(op, type="ok")
        if op.f == "dequeue":
            method, _props, body = self.channel.basic_get(QUEUE)
            if method is None:
                return replace(op, type="fail", error="empty")
            self.channel.basic_ack(method.delivery_tag)
            return replace(op, type="ok", value=decode(body))
        if op.f == "drain":
            out = []
            while True:
                method, _props, body = self.channel.basic_get(QUEUE)
                if method is None:
                    break
                self.channel.basic_ack(method.delivery_tag)
                out.append(decode(body))
            return replace(op, type="ok", value=out)
        raise ValueError(f"unknown f {op.f!r}")

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


def queue_client() -> QueueClient:
    return QueueClient()


def rabbit_test(opts: dict) -> dict:
    """rabbitmq_test.clj:46-80: queue ops under long partitions, then a
    final drain from every process."""
    return fixtures.noop_test() | dict(opts) | {
        "name": "rabbitmq-simple-partition",
        "os": debian.os,
        "db": db(),
        "client": queue_client(),
        "model": basic.UnorderedQueue(),
        "checker": checker_mod.compose({
            "queue": basic.queue(),
            "total_queue": basic.total_queue(),
            # opt-in (--queue-linear): FULL device linearizability
            # over the multiset model, beyond the model-reduce
            **basic.queue_linear_entry(opts),
        }),
        "nemesis": nemesis.partition_random_halves(),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time_limit", 360),
                gen.nemesis(
                    gen.seq(itertools.cycle(
                        [gen.sleep(60), {"type": "info", "f": "start"},
                         gen.sleep(60), {"type": "info", "f": "stop"}])),
                    gen.delay(0.1, gen.queue()))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.log("waiting for recovery"),
            gen.sleep(60),
            gen.clients(gen.each(
                lambda: gen.once({"type": "invoke", "f": "drain",
                                  "value": None})))),
    }


def add_opts(p):
    basic.add_queue_linear_opts(p)


def main(argv=None):
    cli.main(cli.single_test_cmd(rabbit_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
