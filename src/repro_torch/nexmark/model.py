"""NEXMark entities: people auctioning items and bidding on them."""

from __future__ import annotations

US_STATES = ("AZ", "CA", "ID", "OR", "WA", "WY")
CITIES = ("Phoenix", "Los Angeles", "San Francisco", "Boise", "Portland",
          "Seattle", "Cheyenne")


class Person:
    __slots__ = ("id", "name", "email", "city", "state", "ts")

    def __init__(self, id: int, name: str, email: str, city: str, state: str,
                 ts: int):
        self.id = id
        self.name = name
        self.email = email
        self.city = city
        self.state = state
        self.ts = ts

    def __repr__(self):  # pragma: no cover
        return f"Person({self.id}, {self.state})"


class Auction:
    __slots__ = ("id", "seller", "category", "initial_bid", "expires", "ts")

    def __init__(self, id: int, seller: int, category: int, initial_bid: int,
                 expires: int, ts: int):
        self.id = id
        self.seller = seller
        self.category = category
        self.initial_bid = initial_bid
        self.expires = expires
        self.ts = ts

    def __repr__(self):  # pragma: no cover
        return f"Auction({self.id}, seller={self.seller})"


class Bid:
    __slots__ = ("auction", "bidder", "price", "ts")

    def __init__(self, auction: int, bidder: int, price: int, ts: int):
        self.auction = auction
        self.bidder = bidder
        self.price = price
        self.ts = ts

    def __repr__(self):  # pragma: no cover
        return f"Bid(a={self.auction}, p={self.price})"
